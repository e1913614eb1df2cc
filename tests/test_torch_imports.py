"""The port stands alone: importing ``repro_torch`` and every submodule
(``repro_torch.obs`` among them), and ``chip_smoke``, loads no ``jax*`` module and nothing of the reference
package ``repro``. Runs in a fresh interpreter so this process's imports
cannot mask a leak."""
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
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith(("jax.", "jaxlib", "repro.")) or m == "repro")
print(len(names), "modules;", "leaked:", bad)
obs = all(n in names for n in ("repro_torch.obs", "repro_torch.obs.metrics",
                                "repro_torch.obs.recorder", "repro_torch.obs.trace"))
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
