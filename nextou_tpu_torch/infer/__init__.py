from nextou_tpu_torch.infer.sliding_window import (
    compute_sliding_window_steps,
    gaussian_importance_map,
    make_device_sliding_predictor,
)
