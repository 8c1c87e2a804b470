"""SGD with momentum (the paper's optimizer) and AdamW, written by hand.

State layout ``{"mu": tree, ["nu": tree], "step": int32 tensor}``, with
``mu``/``nu`` mirroring the parameters so WASH+Opt can replay the
parameter shuffle plan on them verbatim (``core.mixing``).
"""

from repro_torch.optim.optimizers import (
    adamw_init,
    adamw_update,
    cosine_lr,
    make_optimizer,
    sgd_init,
    sgd_update,
)

__all__ = ["sgd_init", "sgd_update", "adamw_init", "adamw_update",
           "cosine_lr", "make_optimizer"]
