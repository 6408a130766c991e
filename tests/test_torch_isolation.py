"""The port imports neither JAX nor the JAX package.

Checked in a fresh interpreter: this test process already holds ``jax``
(tests/conftest.py imports it), so ``sys.modules`` here proves nothing.
"""

import os
import subprocess
import sys

PORT_MODULES = (
    "deepspeed_tpu_torch",
    "deepspeed_tpu_torch.accelerator.real_accelerator",
    "deepspeed_tpu_torch.utils.logging",
    "deepspeed_tpu_torch.models.api",
    "deepspeed_tpu_torch.models.llama",
    "deepspeed_tpu_torch.models.paged",
    "deepspeed_tpu_torch.models.convert",
    "deepspeed_tpu_torch.ops.attention",
    "deepspeed_tpu_torch.ops.cuda._build",
    "deepspeed_tpu_torch.ops.cuda.paged_attention",
    "deepspeed_tpu_torch.inference.ragged",
    "deepspeed_tpu_torch.config.base",
    "deepspeed_tpu_torch.config.config",
    "deepspeed_tpu_torch.ops.optimizers",
    "deepspeed_tpu_torch.ops.cuda.flash_attention",
    "deepspeed_tpu_torch.runtime.lr_schedules",
    "deepspeed_tpu_torch.runtime.precision",
    "deepspeed_tpu_torch.runtime.engine",
    "deepspeed_tpu_torch.utils.timer",
)

_PROBE = """
import importlib, sys
for name in sys.argv[1:]:
    importlib.import_module(name)
import deepspeed_tpu_torch
deepspeed_tpu_torch.RaggedInferenceEngine, deepspeed_tpu_torch.llama
deepspeed_tpu_torch.initialize, deepspeed_tpu_torch.Engine, deepspeed_tpu_torch.load_config
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "deepspeed_tpu"))
print(",".join(bad))
"""


def test_port_imports_no_jax():
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = repo
    proc = subprocess.run([sys.executable, "-c", _PROBE, *PORT_MODULES],
                          capture_output=True, text=True, env=env, cwd=repo,
                          timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "", f"port pulled in: {proc.stdout.strip()}"
