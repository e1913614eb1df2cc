"""The port's data layer (``repro_torch.data``) against the reference's
(``repro.data``): ``TokenPipeline`` batches bitwise equal for a decoder, a
``vision_stub`` and an encoder config, a restored pipeline resumes the
stream exactly, ``make_batch`` draws the reference's values in its order,
and ``input_specs`` gives the reference's shapes."""
import numpy as np
import pytest
import torch

from repro.configs import SHAPES as REF_SHAPES
from repro.configs import get_config as ref_config
from repro.data.pipeline import TokenPipeline as RefPipeline
from repro.data.specs import input_specs as ref_input_specs
from repro.data.specs import make_batch as ref_make_batch
from repro_torch.configs import SHAPES, get_config
from repro_torch.data.pipeline import TokenPipeline
from repro_torch.data.specs import as_tensors, input_specs, make_batch
from repro_torch.models.common import DTYPES

ARCHS = ["stablelm_3b", "internvl2_1b", "hubert_xlarge"]


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("reduced", [True, False])
def test_pipeline_batches_equal_reference_bitwise(arch, reduced):
    rcfg, pcfg = ref_config(arch), get_config(arch)
    if reduced:
        rcfg, pcfg = rcfg.reduced(), pcfg.reduced()
    seq = 64 if reduced else 16
    ref, port = RefPipeline(rcfg, batch=2, seq=seq, seed=5), TokenPipeline(pcfg, batch=2,
                                                                           seq=seq, seed=5)
    for _ in range(3):
        want, got = ref.next_batch(), port.next_batch()
        assert list(got) == list(want)
        for key in want:
            assert got[key].dtype == want[key].dtype
            np.testing.assert_array_equal(got[key], want[key])
    assert port.state() == ref.state() == dict(seed=5, step=3)
    np.testing.assert_array_equal(port.peek(7)["labels"], ref.peek(7)["labels"])


def test_pipeline_shapes_per_family():
    enc = TokenPipeline(get_config("hubert_xlarge").reduced(), batch=2, seq=16).next_batch()
    assert enc["embeddings"].shape == (2, 16, 128) and set(enc) == {"embeddings", "labels"}
    vis = TokenPipeline(get_config("internvl2_1b").reduced(), batch=2, seq=16).next_batch()
    assert vis["patches"].shape == (2, 8, 128) and vis["tokens"].shape == (2, 8)
    assert vis["labels"].shape == (2, 16)
    vis = TokenPipeline(get_config("internvl2_1b").reduced(), batch=2, seq=10).next_batch()
    assert vis["patches"].shape == (2, 5, 128) and vis["tokens"].shape == (2, 5)


def test_pipeline_deterministic_resume():
    cfg = get_config("stablelm_3b").reduced()
    p1 = TokenPipeline(cfg, batch=2, seq=16, seed=3)
    batches = [p1.next_batch() for _ in range(5)]
    p2 = TokenPipeline(cfg, batch=2, seq=16, seed=3)
    p2.restore(dict(seed=3, step=3))
    np.testing.assert_array_equal(batches[3]["tokens"], p2.next_batch()["tokens"])
    np.testing.assert_array_equal(batches[4]["labels"], p2.next_batch()["labels"])


@pytest.mark.parametrize("kind", ["train", "prefill"])
@pytest.mark.parametrize("arch", ARCHS)
def test_make_batch_draws_the_reference_values(arch, kind):
    rcfg, pcfg = ref_config(arch).reduced(), get_config(arch).reduced()
    want = ref_make_batch(np.random.default_rng(3), rcfg, B=2, S=24, kind=kind)
    got = make_batch(np.random.default_rng(3), pcfg, 2, 24, kind=kind, device="cpu")
    assert list(got) == list(want)
    for key, w in want.items():
        w = np.asarray(w)
        if w.dtype.kind == "f":
            assert got[key].dtype == DTYPES[pcfg.compute_dtype]
            np.testing.assert_array_equal(got[key].numpy(), w)
        else:
            assert got[key].dtype == torch.int64
            np.testing.assert_array_equal(got[key].numpy(), w.astype(np.int64))


def test_as_tensors_casts_to_the_compute_type():
    cfg = get_config("internvl2_1b").reduced().with_(compute_dtype="bfloat16")
    batch = TokenPipeline(cfg, batch=2, seq=16, seed=1).next_batch()
    got = as_tensors(batch, cfg, "cpu")
    assert got["patches"].dtype == torch.bfloat16 and got["tokens"].dtype == torch.int64
    np.testing.assert_array_equal(got["patches"].float().numpy(),
                                  torch.from_numpy(batch["patches"]).bfloat16().float().numpy())
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            as_tensors(batch, cfg)


# an encoder has no decode cell (configs.cells_for skips it)
@pytest.mark.parametrize("arch,shape", [
    (a, s) for a in ("stablelm_3b", "internvl2_1b", "hubert_xlarge", "zamba2_1_2b")
    for s in SHAPES if not (get_config(a).is_encoder and SHAPES[s].kind == "decode")])
def test_input_specs_match_reference_shapes(arch, shape):
    rcfg, pcfg = ref_config(arch), get_config(arch)
    want = ref_input_specs(rcfg, REF_SHAPES[shape])
    got = input_specs(pcfg, SHAPES[shape])
    assert list(got) == list(want)
    for key, w in want.items():
        if key == "cache":
            assert {k: tuple(s) for k, (s, _) in got[key].items()} == {
                k: tuple(v.shape) for k, v in w.items()}
        else:
            assert tuple(got[key][0]) == tuple(w.shape)
