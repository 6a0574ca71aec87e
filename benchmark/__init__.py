"""The benchmark of the PyTorch and CUDA port (``sam3_lora_tpu_torch``):
``python -m benchmark.run --workload <name> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` once."""
