"""The port stands alone: importing ``repro_torch`` and every submodule
(``repro_torch.obs``, the host-loop oracles ``repro_torch.core.cohort``
and ``repro_torch.core.eventsim``, the MoE layer ``repro_torch.models.moe``,
the training package ``repro_torch.training``, the data package
``repro_torch.data``, the ``repro_torch.distributed`` package,
``repro_torch.core.sharded``, the ``repro_torch.launch`` package,
``repro_torch.models.moe_ep``, ``repro_torch.distributed.sharding`` and
``repro_torch.distributed.pipeline`` among them), ``chip_smoke`` and the port's
benchmark ``benchmarks.torch_systems`` loads no ``jax*`` module and nothing
of the reference package ``repro``. Runs in a fresh interpreter so this
process's imports cannot mask a leak."""
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent

_PROBE = r"""
import importlib, pkgutil, sys
sys.path[:0] = [{src!r}, {root!r}]
import repro_torch
names = ["repro_torch"]
for info in pkgutil.walk_packages(repro_torch.__path__, "repro_torch."):
    importlib.import_module(info.name)
    names.append(info.name)
import chip_smoke
import benchmarks.torch_systems
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith(("jax.", "jaxlib", "repro.")) or m == "repro")
print(len(names), "modules;", "leaked:", bad)
obs = all(n in names for n in ("repro_torch.obs", "repro_torch.obs.metrics",
                                "repro_torch.obs.recorder", "repro_torch.obs.trace",
                                "repro_torch.core.cohort", "repro_torch.core.eventsim",
                                "repro_torch.models.moe", "repro_torch.training",
                                "repro_torch.training.optimizer",
                                "repro_torch.training.compression",
                                "repro_torch.training.checkpoint",
                                "repro_torch.training.train_loop", "repro_torch.data",
                                "repro_torch.data.pipeline", "repro_torch.data.specs",
                                "repro_torch.distributed", "repro_torch.distributed.context",
                                "repro_torch.distributed.world", "repro_torch.core.sharded",
                                "repro_torch.launch", "repro_torch.launch.mesh",
                                "repro_torch.models.moe_ep", "repro_torch.distributed.sharding",
                                "repro_torch.distributed.pipeline"))
print("obs walked:", obs)
sys.exit(1 if bad or len(names) < 15 or not obs else 0)
"""


def test_port_imports_neither_jax_nor_reference():
    proc = subprocess.run(
        [sys.executable, "-c", _PROBE.format(src=str(ROOT / "src"), root=str(ROOT))],
        capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "leaked: []" in proc.stdout and "obs walked: True" in proc.stdout
