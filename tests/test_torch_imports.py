"""The PyTorch port imports nothing of JAX or Flax, and nothing of the JAX
package (``sam3_lora_tpu``), serving and training alike: the machine with
the GPU has no use for them, and the port keeps its own copies of what it
needs (config, tokenizer, the RLE codec and its C++
source, the image evaluators, ``cli/prepare_data.py``, ``interactive.py``,
``io_utils.py``, ``eval/video_eval.py``, ``HostShard`` and
``filesystem_gather``, ``train/video_data.py``, ``eval/saco_veval.py``,
``viz.py``, ``agent.py``, ``agent_tools.py`` with its prompt corpus,
``agent_helpers.py``, ``utils/instantiate.py``, the augmentation pipeline
``train/transforms.py`` and the checkpoint converter's tables)."""

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
    "import sam3_lora_tpu_torch.ops.window_attention, sam3_lora_tpu_torch.ops.window_qkv\n"
    "import sam3_lora_tpu_torch.ops.remat, sam3_lora_tpu_torch.ops.attention\n"
    "import sam3_lora_tpu_torch.ops.rle as r\n"
    "r.segmentation_to_mask({'size': [2, 2], 'counts': [1, 2, 1]}, 2, 2)\n"
    "import sam3_lora_tpu_torch.cli.train, sam3_lora_tpu_torch.train.data\n"
    "import sam3_lora_tpu_torch.ops.probe_kernels, sam3_lora_tpu_torch.probes.window_cost\n"
    "import sam3_lora_tpu_torch.measure\n"
    "import sam3_lora_tpu_torch.probes.dma_floor, sam3_lora_tpu_torch.probes.packed\n"
    "import sam3_lora_tpu_torch.processor, sam3_lora_tpu_torch.ops.masks, sam3_lora_tpu_torch.ops.nms\n"
    "import sam3_lora_tpu_torch.eval, sam3_lora_tpu_torch.eval.coco_map, sam3_lora_tpu_torch.eval.cgf1\n"
    "import sam3_lora_tpu_torch.eval.tide, sam3_lora_tpu_torch.eval.writer\n"
    "import sam3_lora_tpu_torch.cli.validate, sam3_lora_tpu_torch.cli.compare\n"
    "r.rle_decode(r.rle_encode(__import__('numpy').eye(3, dtype=bool)))\n"
    "import sam3_lora_tpu_torch.ops.rle_native, sam3_lora_tpu_torch.train.optim\n"
    "import sam3_lora_tpu_torch.cli.prepare_data, sam3_lora_tpu_torch.interactive\n"
    "import sam3_lora_tpu_torch.models.sam_heads, sam3_lora_tpu_torch.models.tracker\n"
    "import sam3_lora_tpu_torch.predictor\n"
    "import sam3_lora_tpu_torch.io_utils, sam3_lora_tpu_torch.ops.cc, sam3_lora_tpu_torch.ops.association\n"
    "import sam3_lora_tpu_torch.video, sam3_lora_tpu_torch.video_predictor\n"
    "import sam3_lora_tpu_torch.tracking_predictor, sam3_lora_tpu_torch.eval.video_eval\n"
    "import sam3_lora_tpu_torch.cli.video\n"
    "import sam3_lora_tpu_torch.parallel, sam3_lora_tpu_torch.parallel.multihost\n"
    "import sam3_lora_tpu_torch.parallel.mesh, sam3_lora_tpu_torch.parallel.dist_utils\n"
    "import sam3_lora_tpu_torch.parallel.frame_parallel, sam3_lora_tpu_torch.utils.logging\n"
    "from sam3_lora_tpu_torch.utils import setup_logging, TensorBoardLogger, MemMeter\n"
    "from sam3_lora_tpu_torch.utils.checkpoint import save_base_checkpoint\n"
    "import sam3_lora_tpu_torch.train.video_losses, sam3_lora_tpu_torch.train.video_data\n"
    "import sam3_lora_tpu_torch.eval.saco_veval, sam3_lora_tpu_torch.viz\n"
    "import sam3_lora_tpu_torch.agent, sam3_lora_tpu_torch.agent_helpers\n"
    "import sam3_lora_tpu_torch.agent_tools as at; at.load_system_prompt('grounding_agent')\n"
    "import sam3_lora_tpu_torch.utils.instantiate as ui\n"
    "ui.instantiate({'_target_': 'sam3_lora_tpu_torch.config.LoRAConfig', 'rank': 2})\n"
    "from sam3_lora_tpu_torch.ops.cc import sample_point_from_error_region\n"
    "import sam3_lora_tpu_torch.cli.convert_checkpoint, sam3_lora_tpu_torch.train.transforms\n"
    "import sam3_lora_tpu_torch.cli.check_text_encoding, sam3_lora_tpu_torch.cli.analyze_loss\n"
    "import sam3_lora_tpu_torch.cli.verify_gt_transforms, sam3_lora_tpu_torch.ops.interpolate\n"
    "from sam3_lora_tpu_torch.models.lora import merge_lora_into_base, lora_module_names\n"
    "import chip_smoke\n"
    "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'flax', 'sam3_lora_tpu')]\n"
    "assert not bad, bad\n"
)


def test_port_imports_no_jax():
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    subprocess.run([sys.executable, "-c", CODE], check=True, cwd=root, timeout=120)
