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
           "repro_torch.data", "repro_torch.data.updates",
           "repro_torch.data.pipeline", "repro_torch.models.moe",
           "repro_torch.kernels.flash_attention",
           "repro_torch.kernels.flash_decode", "repro_torch.configs",
           "repro_torch.configs.base", "repro_torch.models",
           "repro_torch.models.layers", "repro_torch.models.attention",
           "repro_torch.models.model", "repro_torch.models.weights",
           "repro_torch.models.ssm", "repro_torch.models.xlstm",
           "repro_torch.serve", "repro_torch.serve.engine",
           "repro_torch.serve.incremental_views", "repro_torch.launch",
           "repro_torch.launch.serve", "repro_torch.plan",
           "repro_torch.plan.planner", "repro_torch.plan.trigger_cache",
           "repro_torch.plan.adaptive", "repro_torch.plan.calibrate",
           "repro_torch.kernels.select_commit", "repro_torch.guard",
           "repro_torch.guard.validate", "repro_torch.guard.chaos",
           "repro_torch.guard.txn", "repro_torch.guard.sentinel",
           "repro_torch.guard.degrade", "repro_torch.fleet",
           "repro_torch.fleet.lease", "repro_torch.fleet.admission",
           "repro_torch.fleet.tenant", "repro_torch.fleet.scheduler",
           "repro_torch.train", "repro_torch.train.grad_compression",
           "repro_torch.train.optimizer", "repro_torch.train.train_step",
           "repro_torch.fivm", "repro_torch.fivm.ring",
           "repro_torch.fivm.solvers", "repro_torch.fivm.registry",
           "repro_torch.apps.fivm_learning", "repro_torch.dist",
           "repro_torch.dist.checkpoint", "repro_torch.dist.fault_tolerance",
           "repro_torch.launch.train", "repro_torch.dist.ivm_shard",
           "repro_torch.launch.mesh", "repro_torch.dist.sharding",
           "repro_torch.roofline", "repro_torch.roofline.hw",
           "repro_torch.roofline.analysis", "repro_torch.roofline.op_walk",
           "repro_torch.roofline.kernel_work",
           "repro_torch.roofline.report_md", "repro_torch.launch.dryrun"]

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
    "dual_matmul", "flash_attention", "flash_attention_bwd",
    "flash_decode", "rank_update",
    "rank_update_rows", "select_commit"], cuda_build.sources()
print("BAD", bad)
"""


def test_port_imports_neither_jax_nor_the_jax_package():
    env = dict(os.environ, PYTHONPATH=str(SRC))
    out = subprocess.run([sys.executable, "-c", PROBE, *MODULES], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "BAD []"
