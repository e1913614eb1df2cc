"""Expert-parallel MoE serving across ranks with the PyTorch port.

granite-moe-1b (32 experts of F=512, top-8) served with its experts split
over the ranks of a ``data x model`` mesh: every rank runs the same
``PotusDispatcher`` -> ``ReplicaFleet`` -> ``ServingEngine`` on the same
requests (SPMD); attention and the KV cache are replicated, and only the
MoE layers exchange data (``models/moe_ep.py``: two all_to_alls over
"data" and a psum over "model" a layer). One rank per card under torchrun
(NCCL), from the repository root:

  PYTHONPATH=src torchrun --standalone --nproc-per-node 4 examples/torch_moe_ep.py

prints one JSON line: rank 0's decode-round ms (median), the share of
the served run's wall in collectives, the elements they moved, and whether
every rank's tokens are identical. Under NCCL a collective returns once it
is queued on the card, so the share is then that of enqueueing them
(``collective_enqueue_share``); under gloo it is the exchanges' own. ``--layers`` cuts the depth (24 by
default), ``--device cpu`` runs the ranks on the CPU under gloo.

The module-level functions run on one rank of a world that is already up
(``repro_torch.distributed.spawn_world`` starts one in child processes):
:func:`layer_rank` (``moe_ffn_ep`` on one layer), :func:`model_rank`
(``forward``, ``prefill`` and ``decode_step`` under a mesh) and
:func:`serve_rank` (a served run). Each builds its mesh with
``launch.mesh.make_host_mesh``, so every rank of the world calls it.
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
from repro_torch.distributed import PAYLOAD, set_mesh
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import model_zoo as pz
from repro_torch.models.moe import MoE
from repro_torch.models.moe_ep import moe_ffn_ep, place_
from repro_torch.serving import dispatcher as pd
from repro_torch.serving import fleet as pf
from repro_torch.serving.engine import Request, ServingEngine

MAX_BATCH, PER_SLOT = 4, 2  # a served run's slots per replica and arrivals per slot


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def layer_rank(cfg, mesh, state, xs, router_state=None, device="cuda"):
    """One MoE layer of ``cfg`` with the whole weights ``state`` (an
    ``MoE`` state dict), cut to this rank's blocks on ``mesh`` (a
    ``ModelMesh``, or its (n_data, n_model) shape to build one), then
    ``moe_ffn_ep`` on each of ``xs`` in turn, the router state carried.
    Returns one dict a call: ``y`` and the aux tensors on the CPU,
    ``elements`` and ``collective_s`` (the ``"ep"`` payload) and ``wall_s``."""
    if isinstance(mesh, tuple):
        mesh = make_host_mesh(*mesh)
    moe = MoE(cfg, dtype=state["w_gate"].dtype, device=device)
    moe.load_state_dict(state)
    place_(moe.requires_grad_(False), mesh)
    rs = None if router_state is None else router_state.to(device)
    xs = [x.to(device) for x in xs]
    out = []
    with torch.no_grad():
        for x in xs:
            PAYLOAD.reset()
            _sync(device)
            t0 = time.perf_counter()
            y, aux = moe_ffn_ep(moe, x, cfg, mesh, rs)
            _sync(device)
            wall = time.perf_counter() - t0
            rs = aux["router_state"]
            out.append(dict({k: None if v is None else v.cpu() for k, v in aux.items()},
                            y=y.cpu(), elements=PAYLOAD.n("ep"), collective_s=PAYLOAD.seconds,
                            wall_s=wall))
    return out


def _placed_model(cfg, mesh_shape, state, device):
    """The decoder of ``cfg`` with the weights ``state`` (None: drawn from
    seed 0), its experts placed on the mesh, which is set as the ambient
    one (None for ``mesh_shape`` None)."""
    mesh = None if mesh_shape is None else make_host_mesh(*mesh_shape)
    gen = torch.Generator(device=device).manual_seed(0)
    model = pz.init(cfg, gen, device)
    if state is not None:
        model.load_state_dict(state)
    if mesh is not None:
        place_(model, mesh)
    set_mesh(mesh)
    return model


def model_rank(cfg, mesh_shape, state, tokens, max_len, fed, device="cuda"):
    """``forward`` on ``tokens`` (B, S), ``prefill`` of the same tokens and
    a ``decode_step`` for each (B, 1) row of ``fed``, under the mesh.
    Returns numpy logits: ``forward``, ``prefill`` and ``decode`` (one per
    step), the forward's ``router_state`` and ``elements``, the ``"ep"``
    payload of the whole (0 where no MoE layer ran ``moe_ffn_ep``)."""
    model = _placed_model(cfg, mesh_shape, state, device)
    PAYLOAD.reset()
    try:
        tok = torch.as_tensor(tokens, dtype=torch.long, device=device)
        logits, aux = pz.forward(model, cfg, {"tokens": tok})
        pre, cache = pz.prefill(model, cfg, {"tokens": tok}, max_len)
        pos = torch.full((tok.shape[0],), tok.shape[1], dtype=torch.int32, device=device)
        steps = []
        for f in fed:
            lg, cache = pz.decode_step(model, cfg, torch.as_tensor(f, device=device), pos, cache)
            steps.append(lg.float().cpu().numpy())
            pos = pos + 1
    finally:
        set_mesh(None)
    return dict(forward=logits.float().cpu().numpy(), prefill=pre.float().cpu().numpy(),
                decode=np.stack(steps), router_state=aux["router_state"].cpu().numpy(),
                elements=PAYLOAD.n("ep"))


def serve_rank(cfg, mesh_shape, prompts, max_new, rates=(2.0, 1.0), device="cuda"):
    """A served run on this rank: ``prompts`` (token arrays) arrive
    ``PER_SLOT`` a slot at one frontend, ``PotusDispatcher`` routes them to
    a ``ReplicaFleet`` of ``ServingEngine`` replicas (one per rate, each of
    ``MAX_BATCH`` slots) sharing the decoder of ``cfg`` (weights from seed 0
    on ``device``), its experts on a ``mesh_shape`` mesh (None: no mesh),
    until every request has ``max_new`` tokens. Under a mesh with ep ranks
    on "data", ``MAX_BATCH`` and every prompt length must be multiples of
    ep (a decode round runs every slot, a prefill one prompt), else the
    first MoE layer raises ``ValueError``. Returns ``tokens``
    {rid: [...]}, ``slots``, ``rounds``, ``round_ms`` (every decode round's
    wall ms), ``wall_s``, ``elements`` and ``collective_s`` (the ``"ep"``
    payload; under NCCL the seconds to enqueue it)."""
    model = _placed_model(cfg, mesh_shape, None, device)
    try:
        max_len = max(len(p) for p in prompts) + max_new + 1
        engine_cls = _timed_engine(ServingEngine)
        R = len(rates)
        fleet = pf.ReplicaFleet([engine_cls(cfg, model, max_batch=MAX_BATCH, max_len=max_len,
                                            service_rate=r) for r in rates])
        disp = pd.PotusDispatcher(
            n_frontends=1, replica_hosts=np.arange(1, R + 1), frontend_hosts=np.array([0]),
            host_costs=(np.ones((R + 1, R + 1)) - np.eye(R + 1)).astype(np.float32),
            replica_rates=np.array(rates), device=device,
            cfg=pd.DispatcherConfig(V=1.0, gamma=16.0, tokens_per_request=float(max_new)))
        reqs = [Request(i, np.asarray(p), max_new=max_new) for i, p in enumerate(prompts)]
        waiting = list(reqs)
        PAYLOAD.reset()
        _sync(device)
        t0 = time.perf_counter()
        t = 0
        while waiting or not all(r.done for r in reqs):
            if t >= 100 * len(reqs):
                raise RuntimeError(f"serve_rank: requests still open after {t} slots")
            new, waiting = waiting[:PER_SLOT], waiting[PER_SLOT:]
            assign = pd.integral_assign(disp.route(np.array([float(len(new))]),
                                                   fleet.backlog_tokens))
            for r in range(R):
                for _ in range(int(assign[0, r])):
                    if new:
                        fleet.dispatch(r, new.pop(0))
            waiting = new + waiting  # what the assignment left goes again next slot
            fleet.step(t)
            t += 1
        _sync(device)
        wall = time.perf_counter() - t0
    finally:
        set_mesh(None)
    return dict(tokens={r.rid: list(r.generated) for r in reqs}, slots=t,
                rounds=sum(e.decode_rounds for e in fleet.replicas),
                round_ms=[ms for e in fleet.replicas for ms in getattr(e, "round_ms", [])],
                wall_s=wall, elements=PAYLOAD.n("ep"), collective_s=PAYLOAD.seconds)


def _timed_engine(base):
    """``base`` recording each decode round's wall ms (each round ends in a
    device-to-host copy of its tokens, which waits for the device)."""

    class TimedEngine(base):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            self.round_ms = []

        def _decode_round(self):
            t0 = time.perf_counter()
            out = super()._decode_round()
            self.round_ms.append((time.perf_counter() - t0) * 1e3)
            return out

    return TimedEngine


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--layers", type=int, default=24)
    ap.add_argument("--model-ranks", type=int, default=1, help="size of the 'model' axis")
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args()
    if "RANK" in os.environ:  # started by torchrun: one rank per card
        if args.device == "cuda":
            torch.cuda.set_device(int(os.environ["LOCAL_RANK"]))
        dist.init_process_group("nccl" if args.device == "cuda" else "gloo")
    world = dist.get_world_size() if dist.is_initialized() else 1
    device = (torch.device("cuda", torch.cuda.current_device()) if args.device == "cuda"
              else torch.device("cpu"))
    cfg = get_config("granite_moe_1b").with_(n_layers=args.layers, moe_ep_shardmap=True)
    mesh_shape = (world // args.model_ranks, args.model_ranks)
    rng = np.random.default_rng(0)
    ep = mesh_shape[0]
    prompts = [rng.integers(0, cfg.vocab_size, ep * int(rng.integers(8, 129)))
               for _ in range(args.requests)]
    kw = dict(max_new=args.max_new, rates=(4.0, 2.0, 2.0, 2.0), device=device)
    serve_rank(cfg, mesh_shape, prompts[:4], **kw)  # warm: the kernels' first launches
    out = serve_rank(cfg, mesh_shape, prompts, **kw)
    toks = [out["tokens"]] * world
    if dist.is_initialized():
        dist.all_gather_object(toks, out["tokens"])
    if not dist.is_initialized() or dist.get_rank() == 0:
        name = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
        print(json.dumps({
            "ranks": world, "mesh": mesh_shape, "layers": args.layers, "device": name,
            "backend": dist.get_backend() if dist.is_initialized() else None,
            "requests": args.requests, "slots": out["slots"], "rounds": out["rounds"],
            "decode_round_ms_median": float(np.median(out["round_ms"])),
            "wall_s": out["wall_s"],
            ("collective_enqueue_share" if dist.is_initialized() and dist.get_backend() == "nccl"
             else "collective_share"): out["collective_s"] / out["wall_s"],
            "ep_elements": out["elements"], "ranks_identical": all(t == toks[0] for t in toks)}))
    if dist.is_initialized():
        dist.barrier()
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
