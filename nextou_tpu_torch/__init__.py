"""NexToU in PyTorch for NVIDIA Hopper: the port of ``nextou_tpu``.

Mirrors the JAX package's layout; the JAX package is the reference that
every module here is tested against.

- ``core``     kNN graph primitives, windowing, relative-position tables
- ``kernels``  hand-written CUDA kernels (``csrc/``) and their plain versions
- ``nn``       conv blocks, graph convs, graphers
- ``models``   the plans -> spec program and the NexToU network
- ``infer``    Gaussian sliding-window inference with mirror TTA (device or
               host accumulation), raw-volume serving, evaluation
- ``data``     NIfTI I/O, preprocessing and resampling; preprocessed cases,
               sampling, augmentation and the loader
- ``compat``   weights from ``nextou_tpu`` variables
- ``parallel`` data parallel over processes (``torch.distributed``), replicas
               over a process's cards
- ``predict``  the prediction CLI (preprocessed or raw cases, fold ensembles);
  ``ensemble``, ``postprocess``, ``evaluate_folder`` and ``run_training``
"""

__version__ = "0.1.0"
