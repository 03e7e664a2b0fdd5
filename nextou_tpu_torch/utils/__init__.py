from nextou_tpu_torch.utils.init import init_weights
