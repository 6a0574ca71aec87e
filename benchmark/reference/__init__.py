"""The plain reference of the benchmark: a frozen copy of the SAM3 image
model, its matcher and its losses in plain PyTorch (``numerics.py`` holds
every product), with no kernel, no remat policy and nothing of the program
under test."""
