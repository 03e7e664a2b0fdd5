from nextou_tpu_torch.compat.weights import (
    extract_network_weights,
    load_train_state,
    variables_to_state_dict,
)
