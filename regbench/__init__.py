"""The benchmark of the PyTorch / CUDA port ``shot_fpfh_tpu_torch``
(``run.py``), its traffic generator, plain reference and metric readers."""
