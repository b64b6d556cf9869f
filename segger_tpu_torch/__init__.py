"""segger_tpu_torch: the PyTorch/CUDA port of segger_tpu.

Tiled prediction with the IST encoder runs on an NVIDIA Hopper GPU; the
GATv2 edge stage and the candidate scoring are hand-written CUDA kernels
(``csrc/``), built with ``nvcc`` at first use.  The package imports torch,
numpy and scipy only, never JAX or ``segger_tpu``.
"""
from .train.trainer import SeggerTrainer, TrainConfig

__all__ = ["SeggerTrainer", "TrainConfig"]
