"""AMP: bfloat16/float16 mixed precision (counterpart of
``mxnet_tpu/amp``, ref: python/mxnet/contrib/amp/)."""
from .amp import (init, init_trainer, scale_loss, unscale,  # noqa: F401
                  convert_hybrid_block, convert_model,
                  list_lp16_ops, list_fp32_ops)
from .loss_scaler import LossScaler  # noqa: F401
