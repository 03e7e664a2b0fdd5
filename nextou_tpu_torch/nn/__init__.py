from nextou_tpu_torch.nn.conv_blocks import ConvNormAct, StackedConvBlocks
from nextou_tpu_torch.nn.graph_conv import (
    DyGraphConv,
    MRConv,
    PoolDyGraphConv,
    avg_pool,
    max_pool_with_argmax,
    max_unpool_scatter,
)
from nextou_tpu_torch.nn.graphers import FFN, PoolGrapher, SwinGrapher
