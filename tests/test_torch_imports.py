"""The PyTorch port imports nothing of JAX or Flax, and nothing of the JAX
package (``sam3_lora_tpu``), serving and training alike: the machine with
the GPU has no use for them, and the port keeps its own copies of what it
needs (config, tokenizer, datapoint transforms, the RLE codec)."""

import os
import subprocess
import sys

CODE = (
    "import sys\n"
    "import sam3_lora_tpu_torch, sam3_lora_tpu_torch.inference, sam3_lora_tpu_torch.cli.infer\n"
    "import sam3_lora_tpu_torch.utils.checkpoint, sam3_lora_tpu_torch.models.lora\n"
    "import sam3_lora_tpu_torch.models.tokenizer as t; t.get_default_tokenizer()(['crack'])\n"
    "import sam3_lora_tpu_torch.train.trainer, sam3_lora_tpu_torch.train.prefetch\n"
    "import sam3_lora_tpu_torch.train.matcher, sam3_lora_tpu_torch.train.losses\n"
    "import sam3_lora_tpu_torch.ops.quant, sam3_lora_tpu_torch.ops.gemm_int8\n"
    "import sam3_lora_tpu_torch.ops.rle as r\n"
    "r.segmentation_to_mask({'size': [2, 2], 'counts': [1, 2, 1]}, 2, 2)\n"
    "import sam3_lora_tpu_torch.cli.train, sam3_lora_tpu_torch.train.data\n"
    "import chip_smoke\n"
    "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'flax', 'sam3_lora_tpu')]\n"
    "assert not bad, bad\n"
)


def test_port_imports_no_jax():
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    subprocess.run([sys.executable, "-c", CODE], check=True, cwd=root, timeout=120)
