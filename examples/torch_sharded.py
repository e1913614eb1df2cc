"""The PyTorch port's instance-sharded cohort engine on several cards.

One rank per card under torchrun (NCCL), from the repository root:

  PYTHONPATH=src torchrun --standalone --nproc-per-node 4 examples/torch_sharded.py

Every rank builds the same serving fleet (4 chains src -> serve -> sink on
fat_tree(4), 8 containers per server, utilization 0.85, the I=16384 fleet
of benchmarks/systems_bench.py's cohort_scale) and calls
simulate(EngineSpec(engine="cohort-fused", sharded=True)): each rank holds
its block of instance rows on its own card and every rank gets the same
result. Rank 0 then runs the dense engine alone on its card, and prints
one JSON line: the wall ms per slot of both, the largest per-slot
backlog/cost gap between them, and the elements the collectives moved per
slot with their share of the sharded wall. ``--device cpu`` runs the ranks
on the CPU under gloo (``torchrun --nproc-per-node 4 ... --device cpu``);
without torchrun the world is one rank.
"""
import argparse
import dataclasses
import json
import os
import time

import numpy as np
import torch
import torch.distributed as dist

import repro_torch.core as pt
from repro_torch.distributed import PAYLOAD


def fleet(n_instances: int, T: int):
    chains, per = 4, n_instances // 4
    edge = max(per // 8, 1)
    C = pt.Component
    apps = [[C("src", a, True, parallelism=edge, successors=(1,)),
             C("serve", a, False, parallelism=per - 2 * edge, proc_capacity=4.0,
               successors=(2,)),
             C("sink", a, False, parallelism=edge, proc_capacity=8.0)] for a in range(chains)]
    topo = pt.build_topology(apps, gamma=32.0)
    sd, _ = pt.fat_tree(4)
    net = pt.container_costs(f"cohort-fleet-{topo.n_instances}", sd, containers_per_server=8)
    rng = np.random.default_rng(0)
    placement = rng.integers(0, net.n_containers, topo.n_instances).astype(np.int32)
    rates = pt.feasible_rates(topo, utilization=0.85)
    return topo, net, placement, pt.poisson_arrivals(rng, rates, T + 8)


def timed(fn, device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    out = fn()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return out, time.perf_counter() - t0


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--instances", type=int, default=16384)
    ap.add_argument("--slots", type=int, default=32)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args()
    if "RANK" in os.environ:  # started by torchrun: one rank per card
        if args.device == "cuda":
            torch.cuda.set_device(int(os.environ["LOCAL_RANK"]))
        dist.init_process_group("nccl" if args.device == "cuda" else "gloo")
    rank = dist.get_rank() if dist.is_initialized() else 0
    device = torch.device(args.device, torch.cuda.current_device()) \
        if args.device == "cuda" else torch.device("cpu")
    topo, net, placement, arr = fleet(args.instances, args.slots)
    spec = pt.EngineSpec(topo=topo, net=net, placement=placement, arrivals=arr, T=args.slots,
                         scheduler="potus", V=2.0, window=4, age_cap=64, sharded=True,
                         device=args.device)
    pt.simulate(spec)  # warm: the first run pays the CUDA and NCCL start-up
    PAYLOAD.reset()
    sharded, wall = timed(lambda: pt.simulate(spec), device)
    moved, coll_s = PAYLOAD.n(), PAYLOAD.seconds
    if rank == 0:
        dense_spec = dataclasses.replace(spec, sharded=False)
        pt.simulate(dense_spec)  # warm: builds the slot kernel at first use
        dense, dense_wall = timed(lambda: pt.simulate(dense_spec), device)
        gap = max(float(np.max(np.abs(sharded.backlog - dense.backlog)
                               / np.maximum(np.abs(dense.backlog), 1e-12))),
                  float(np.max(np.abs(sharded.comm_cost - dense.comm_cost)
                               / np.maximum(np.abs(dense.comm_cost), 1e-12))))
        name = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
        print(json.dumps({
            "ranks": dist.get_world_size() if dist.is_initialized() else 1,
            "backend": dist.get_backend() if dist.is_initialized() else None,
            "device": name, "instances": topo.n_instances, "slots": args.slots,
            "sharded_ms_per_slot": wall * 1e3 / args.slots,
            "dense_ms_per_slot": dense_wall * 1e3 / args.slots,
            "max_rel_gap_per_slot": gap, "payload_per_slot": moved / args.slots,
            "collective_share": coll_s / wall}))
    if dist.is_initialized():
        dist.barrier()
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
