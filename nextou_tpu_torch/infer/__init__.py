from nextou_tpu_torch.infer.raw import predict_raw_case, predict_raw_folder
from nextou_tpu_torch.infer.sliding_window import (
    compute_sliding_window_steps,
    gaussian_importance_map,
    make_device_sliding_predictor,
    make_tile_predictor,
    sliding_window_predict,
)
