"""The port stands alone: importing it pulls in neither JAX nor the JAX
package, and importing it builds no kernel."""

import os
import subprocess
import sys
from pathlib import Path

SRC = Path(__file__).resolve().parents[1] / "src"

MODULES = ["repro_torch", "repro_torch.core", "repro_torch.core.codegen",
           "repro_torch.core.runtime", "repro_torch.core.factored",
           "repro_torch.core.sherman_morrison", "repro_torch.kernels",
           "repro_torch.kernels.ops", "repro_torch.kernels.ref",
           "repro_torch.kernels.cuda_build",
           "repro_torch.kernels.rank_update",
           "repro_torch.kernels.rank_update_rows",
           "repro_torch.kernels.dual_matmul", "repro_torch.apps",
           "repro_torch.apps.sums_powers",
           "repro_torch.apps.general_iterative",
           "repro_torch.apps.gradient_descent", "repro_torch.apps.pagerank",
           "repro_torch.data", "repro_torch.data.updates"]

PROBE = """
import importlib, sys
for name in sys.argv[1:]:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.")
             or m == "repro" or m.startswith("repro."))
from repro_torch.kernels import cuda_build
assert cuda_build.LIBS == {}, f"built at import: {sorted(cuda_build.LIBS)}"
assert cuda_build.BUILD_LOGS == {}, "nvcc ran at import"
assert sorted(cuda_build.sources()) == [
    "dual_matmul", "rank_update", "rank_update_rows"], cuda_build.sources()
print("BAD", bad)
"""


def test_port_imports_neither_jax_nor_the_jax_package():
    env = dict(os.environ, PYTHONPATH=str(SRC))
    out = subprocess.run([sys.executable, "-c", PROBE, *MODULES], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "BAD []"
