"""Data- and tensor-parallel training across ranks with the PyTorch port —
the SPMD counterpart of ``examples/train_lm.py`` under a model mesh.

Every rank builds the same ``(n, 1)`` mesh (``launch.mesh.make_host_mesh``),
sets it as the ambient one, cuts AdamW's moments to its ZeRO-1 blocks
(``training.train_loop.shard_train_state`` with
``distributed.sharding.train_state_shardings``) and runs the same
``make_train_step`` on the same global batches (``TokenPipeline``), the
gradients reduce-scattered onto the blocks (``grad_specs`` from
``zero_rules``). One rank per card under torchrun (NCCL), from the
repository root:

  PYTHONPATH=src torchrun --standalone --nproc-per-node 4 examples/torch_train_dp.py

prints one JSON line: the step wall ms of each rank (median over the timed
steps), the share of that wall in collectives, each rank's peak device
memory (``max_memory_allocated``), the ``"dp"`` elements a step and the
losses. Under NCCL a collective returns once it is queued on the
card, so the share is then that of enqueueing them
(``collective_enqueue_share``); under gloo it is the exchanges' own.
``--arch`` picks the model (internvl2-1b by default) at its full width,
``--layers`` cuts its depth, ``--device cpu`` runs the ranks on the CPU
under gloo. An MoE model (``--arch granite_moe_1b``) trains with the
global-batch router by default and with ``--ep`` by the expert-parallel
route (``moe_ep_shardmap``: each rank holds E/n experts):

  PYTHONPATH=src torchrun --standalone --nproc-per-node 4 examples/torch_train_dp.py \
      --arch granite_moe_1b --ep

``--model-axis m`` trains a dense or MoE decoder, a ``vision_stub`` config
or an encoder tensor-parallel on a (ranks/m, m) mesh (each rank holds its
blocks of the heads, d_ff and the vocabulary, ``models.common``, and of an
MoE model E/m of the experts, or with ``--ep`` E/(ranks/m) experts cut to
their F/m block), its moments ZeRO-1 blocks over both axes; the heads must
divide by m (internvl2-1b's 14 by 2, hubert-xlarge's 16 by 2 or 4):

  PYTHONPATH=src torchrun --standalone --nproc-per-node 4 examples/torch_train_dp.py \
      --arch stablelm_3b --layers 2 --model-axis 4
  PYTHONPATH=src torchrun --standalone --nproc-per-node 4 examples/torch_train_dp.py \
      --arch granite_moe_1b --layers 8 --model-axis 2 --ep
  PYTHONPATH=src torchrun --standalone --nproc-per-node 4 examples/torch_train_dp.py \
      --arch internvl2_1b --layers 8 --model-axis 2
  PYTHONPATH=src torchrun --standalone --nproc-per-node 4 examples/torch_train_dp.py \
      --arch hubert_xlarge --layers 8 --model-axis 4

The module-level functions run on one rank of a world that is already up
(``repro_torch.distributed.spawn_world`` starts one in child processes):
:func:`train_rank` (train steps under a mesh, ``(n_data, n_model)``),
:func:`checkpoint_rank` (a ZeRO-1 state saved across ranks and restored
onto other meshes) and
:func:`pipeline_rank` (``pipeline_apply`` over a stage axis). Each builds
its meshes, so every rank of the world calls it.
"""
from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.configs import get_config
from repro_torch.data.pipeline import TokenPipeline
from repro_torch.data.specs import as_tensors
from repro_torch.distributed import PAYLOAD, SOLO, set_mesh
from repro_torch.distributed import sharding as shd
from repro_torch.distributed.pipeline import pipeline_apply
from repro_torch.launch.mesh import make_axis_mesh, make_host_mesh
from repro_torch.models import model_zoo as pz
from repro_torch.models.moe_ep import place_
from repro_torch.training import checkpoint as ck
from repro_torch.training.optimizer import OptConfig
from repro_torch.training.train_loop import (TrainConfig, init_train_state, make_train_step,
                                             shard_train_state, state_shardings)


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def _host(tree):
    """A state's tensors (nested dicts, a module's state_dict) as CPU copies."""
    if isinstance(tree, torch.nn.Module):
        return {k: v.detach().cpu().clone() for k, v in tree.state_dict().items()}
    if isinstance(tree, dict):
        return {k: _host(v) for k, v in tree.items()}
    return tree.detach().cpu().clone()


def _state(cfg, tcfg, mesh, weights, device, seed=0):
    """The train state of ``cfg`` (weights ``weights``, a state_dict, or
    drawn from ``seed``), cut to this rank's blocks on ``mesh`` (None:
    whole): the expert-parallel route's experts placed (``place_``), the
    model-cut parameters and the moments cut (``state_shardings``)."""
    state = init_train_state(cfg, tcfg, torch.Generator(device=device).manual_seed(seed),
                             device)
    if weights is not None:
        state["params"].load_state_dict(weights)
    if mesh is not None:
        if cfg.moe and cfg.moe_ep_shardmap:
            place_(state["params"], mesh)
        shard_train_state(state, state_shardings(cfg, mesh, tcfg))
    return state


def _rows(batch: dict, mesh):
    """(this rank's rows of ``batch``, the axis they are cut over), as the
    train step cuts them on an ``(n, 1)`` mesh: the whole batch and
    ``SOLO`` when its rows do not split."""
    n = 1 if mesh is None else mesh.shape["data"]
    B = next(iter(batch.values())).shape[0]
    if n == 1 or B % n:
        return batch, SOLO
    i = mesh.axis("data").index
    return {k: a[i * (B // n):(i + 1) * (B // n)] for k, a in batch.items()}, mesh.axis("data")


@torch.no_grad()
def moe_probe(cfg, state, batch, mesh):
    """The forward of an MoE model on this rank's rows of ``batch`` (numpy),
    as the train step runs it (over the mesh's "model" axis too): each MoE
    layer's ``load``, ``dropped_frac``, ``aux_loss`` and ``router_state``
    (global) and this rank's ``top_i`` and ``keep``, on the CPU."""
    rows, axis = _rows(as_tensors(batch, cfg, state["router_state"].device), mesh)
    tp = SOLO if mesh is None else mesh.axis("model")
    _, aux = pz.forward(state["params"], cfg, rows, state["router_state"], axis=axis, tp=tp)
    keys = ("load", "dropped_frac", "aux_loss", "router_state", "top_i", "keep")
    return [{k: None if a[k] is None else a[k].detach().cpu() for k in keys}
            for a in aux["moe_layers"]]


def train_rank(cfg, tcfg, mesh_shape, weights, batches, *, grad_specs=False, device="cuda",
               keep_state=True, router_state=None, probe=False):
    """Train steps on this rank: the state of ``cfg`` with ``weights`` (None:
    seed 0) and ``router_state`` (None: zeros), on a ``mesh_shape`` mesh set
    as the ambient one (None: no mesh), one ``make_train_step`` call per
    global batch of ``batches`` (numpy dicts); ``grad_specs``
    reduce-scatters the gradients onto the ZeRO-1 blocks. Returns
    ``metrics`` (floats, one dict a step), the step walls ``wall_s``, the
    elements moved by tag (``"dp"``, ``"moe"``, ``"ep"``) and the
    collective seconds of each step, with ``probe`` (an MoE model) the
    forward's layers before the first step (:func:`moe_probe`), and with
    ``keep_state`` the state after the steps on the CPU (``params``, the
    moments' blocks ``m`` and ``v``, ``err``, ``step``, ``router_state``)."""
    mesh = None if mesh_shape is None else make_host_mesh(*mesh_shape)
    set_mesh(mesh)
    try:
        state = _state(cfg, tcfg, mesh, weights, device)
        if router_state is not None:
            state["router_state"] = torch.as_tensor(router_state, device=device)
        specs = None
        if grad_specs:
            specs = shd.specs_for_template(pz.template(cfg), shd.zero_rules(mesh), mesh)
        step = make_train_step(cfg, tcfg, specs)
        out = dict(metrics=[], wall_s=[], elements=[], collective_s=[], tags=[])
        if probe and (mesh is None or mesh.member):
            out["probe"] = moe_probe(cfg, state, batches[0], mesh)
        for batch in batches:
            batch = as_tensors(batch, cfg, device)
            PAYLOAD.reset()
            _sync(device)
            t0 = time.perf_counter()
            state, met = step(state, batch)
            _sync(device)
            out["wall_s"].append(time.perf_counter() - t0)
            out["metrics"].append({k: float(v) for k, v in met.items()})
            out["elements"].append(PAYLOAD.n("dp"))
            out["tags"].append(dict(PAYLOAD.elements))
            out["collective_s"].append(PAYLOAD.seconds)
    finally:
        set_mesh(None)
    if keep_state:
        out["state"] = dict(params=_host(state["params"]), m=_host(state["opt"]["m"]),
                            v=_host(state["opt"]["v"]), step=int(state["opt"]["step"]),
                            router_state=_host(state["router_state"]))
        if "err" in state:
            out["state"]["err"] = _host(state["err"])
    out["member"] = mesh is None or mesh.member
    return out


def checkpoint_rank(cfg, tcfg, mesh_shape, weights, batch, ckpt_dir, restore_shapes,
                    device="cuda"):
    """One train step on a ``mesh_shape`` mesh, the ZeRO-1 state saved to
    ``ckpt_dir`` across the ranks (``save_checkpoint`` with the state's
    shardings, ``state_shardings``) and to ``<ckpt_dir>-async`` (an
    ``AsyncCheckpointer``), then restored onto a mesh of each of
    ``restore_shapes`` (None: no mesh, the whole state on every rank) into
    a fresh state placed and cut for that mesh. Returns this rank's blocks
    before the save (``saved``) and after each restore (``restored``, by
    shape), on the CPU."""
    mesh = make_host_mesh(*mesh_shape)
    set_mesh(mesh)
    try:
        state = _state(cfg, tcfg, mesh, weights, device)
        state, _ = make_train_step(cfg, tcfg)(state, as_tensors(batch, cfg, device))
        shardings = state_shardings(cfg, mesh, tcfg)
        ck.save_checkpoint(ckpt_dir, 1, state, extra=dict(batch_seed=0), shardings=shardings)
        saver = ck.AsyncCheckpointer(f"{ckpt_dir}-async")
        saver.save(1, state, extra=dict(batch_seed=0), shardings=shardings)
        saver.wait()
    finally:
        set_mesh(None)
    out = dict(saved=ck.flatten_state(_host(state)), restored={})
    for shape in restore_shapes:
        there = None if shape is None else make_host_mesh(*shape)
        fresh = _state(cfg, tcfg, there, None, device, seed=1)
        sh = None if there is None else state_shardings(cfg, there, tcfg)
        back, extra = ck.restore_checkpoint(ckpt_dir, 1, fresh, sh)
        out["restored"][shape] = dict(leaves=ck.flatten_state(_host(back)), extra=extra)
    return out


def _stage(p, h):
    return torch.tanh(h @ p["w"] + p["b"])


def pipeline_rank(stage_params, x, n_stages, stage_fn=_stage, device="cuda"):
    """``pipeline_apply`` of ``stage_fn`` (by default ``tanh(h @ w + b)``)
    over a ``"stage"`` axis of the first ``n_stages`` ranks. Returns the
    outputs on the CPU and the ``"pp"`` elements moved."""
    mesh = make_axis_mesh(n_stages, "stage")
    params = {k: v.to(device) for k, v in stage_params.items()}
    PAYLOAD.reset()
    with torch.no_grad():
        out = pipeline_apply(stage_fn, params, x.to(device), mesh, axis="stage")
    return dict(out=out.cpu(), elements=PAYLOAD.n("pp"))


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="internvl2_1b")
    ap.add_argument("--layers", type=int, default=0, help="cut the depth (0: the config's)")
    ap.add_argument("--steps", type=int, default=6)
    ap.add_argument("--batch", type=int, default=8, help="the global batch")
    ap.add_argument("--seq", type=int, default=1024)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--ep", action="store_true",
                    help="an MoE model by the expert-parallel route (moe_ep_shardmap)")
    ap.add_argument("--model-axis", type=int, default=1,
                    help="ranks of the mesh's \"model\" axis (tensor-parallel; not an SSM or "
                         "hybrid model)")
    args = ap.parse_args()
    if "RANK" in os.environ:  # started by torchrun: one rank per card
        if args.device == "cuda":
            torch.cuda.set_device(int(os.environ["LOCAL_RANK"]))
        dist.init_process_group("nccl" if args.device == "cuda" else "gloo")
    world = dist.get_world_size() if dist.is_initialized() else 1
    device = (torch.device("cuda", torch.cuda.current_device()) if args.device == "cuda"
              else torch.device("cpu"))
    cfg = get_config(args.arch)
    if args.layers:
        cfg = cfg.with_(n_layers=args.layers)
    if args.ep:
        cfg = cfg.with_(moe_ep_shardmap=True)
    tcfg = TrainConfig(opt=OptConfig(lr=1e-4, warmup_steps=1, total_steps=100))
    pipe = TokenPipeline(cfg, batch=args.batch, seq=args.seq, seed=0)
    batches = [pipe.next_batch() for _ in range(args.steps)]
    if world % args.model_axis:
        raise SystemExit(f"--model-axis {args.model_axis} does not divide {world} ranks")
    mesh_shape = (world // args.model_axis, args.model_axis)
    out = train_rank(cfg, tcfg, mesh_shape, None, batches, grad_specs=True, device=device,
                     keep_state=False)
    walls = out["wall_s"][1:]  # the first step's launches load the kernels
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else None
    mine = (float(np.median(walls)), float(np.sum(out["collective_s"][1:]) / np.sum(walls)),
            peak)
    per_rank = [mine] * world
    if dist.is_initialized():
        dist.all_gather_object(per_rank, mine)
    if not dist.is_initialized() or dist.get_rank() == 0:
        name = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
        nccl = dist.is_initialized() and dist.get_backend() == "nccl"
        print(json.dumps({
            "ranks": world, "mesh": mesh_shape, "arch": cfg.name, "layers": cfg.n_layers,
            "device": name,
            "backend": dist.get_backend() if dist.is_initialized() else None,
            "global_batch": args.batch, "seq": args.seq, "steps": args.steps,
            "step_ms_median_per_rank": [r[0] * 1e3 for r in per_rank],
            ("collective_enqueue_share" if nccl else "collective_share"):
                [r[1] for r in per_rank],
            "peak_memory_bytes_per_rank": [r[2] for r in per_rank],
            "dp_elements_per_step": out["elements"][-1],
            "elements_per_step_by_tag": out["tags"][-1], "moe_route":
                (None if not cfg.moe else "expert-parallel" if args.ep else "global-batch"),
            "loss": [m["loss"] for m in out["metrics"]]}))
    if dist.is_initialized():
        dist.barrier()
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
