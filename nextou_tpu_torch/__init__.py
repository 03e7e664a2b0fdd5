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
- ``plans``    plans and dataset.json loading, the experiment planner, the
               dataset fingerprint and the raw dataset's integrity check
- ``compat``   weights from ``nextou_tpu`` variables and upstream checkpoints
- ``parallel`` data parallel over processes (``torch.distributed``), replicas
               over a process's cards
- ``predict``  the prediction CLI (preprocessed or raw cases, fold ensembles);
  ``plan_and_preprocess``, ``convert_msd``, ``run_training``,
  ``find_best_configuration``, ``import_torch_checkpoint``, ``ensemble``,
  ``postprocess`` and ``evaluate_folder``
"""

__version__ = "0.1.0"
