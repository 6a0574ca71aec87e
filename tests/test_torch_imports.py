"""The PyTorch port never imports JAX or Flax, serving and training alike:
the machine with the GPU has no use for them, and the port must start
without them."""

import os
import subprocess
import sys

CODE = (
    "import sys\n"
    "import sam3_lora_tpu_torch, sam3_lora_tpu_torch.inference, sam3_lora_tpu_torch.cli.infer\n"
    "import sam3_lora_tpu_torch.utils.checkpoint, sam3_lora_tpu_torch.models.lora\n"
    "import sam3_lora_tpu_torch.models.tokenizer as t; t._module()\n"
    "import sam3_lora_tpu_torch.train.trainer, sam3_lora_tpu_torch.train.prefetch\n"
    "import sam3_lora_tpu_torch.train.matcher, sam3_lora_tpu_torch.train.losses\n"
    "import sam3_lora_tpu_torch.cli.train, sam3_lora_tpu_torch.train.data as d; d._rle()\n"
    "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'flax')]\n"
    "assert not bad, bad\n"
)


def test_port_imports_no_jax():
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    subprocess.run([sys.executable, "-c", CODE], check=True, cwd=root, timeout=120)
