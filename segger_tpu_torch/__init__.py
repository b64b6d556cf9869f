"""segger_tpu_torch: the PyTorch/CUDA port of segger_tpu.

Tiled prediction with the IST encoder runs on an NVIDIA Hopper GPU; the
GATv2 edge stage and the candidate scoring are hand-written CUDA kernels
(``csrc/``), built with ``nvcc`` at first use.  ``segger-tpu-torch``
(``cli/``) reads Xenium, CosMX and MERSCOPE runs (``io/``), segments them
and exports boundaries and tables (``export/``).  ``parallel/`` runs the
whole slide, sharded into strips or a grid with a per-layer halo
exchange, for prediction and training
(``SeggerTrainer.predict_whole_slide`` / ``fit_whole_slide``).  The package imports
torch, numpy, scipy, pandas and pyarrow (``cv2`` for CosMX label images,
``h5py`` for h5ad files, each inside the functions that need it), never
JAX or ``segger_tpu``.
"""
__all__ = ["SeggerTrainer", "TrainConfig"]


def __getattr__(name):
    # imported on first use, so that the host-only modules (the readers,
    # the boundary export and the workers its pool spawns) do not import
    # torch through the package
    if name in __all__:
        from .train import trainer

        return getattr(trainer, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
