from repro_torch.training.optimizer import (  # noqa: F401
    adamw_init, adamw_update, AdamWConfig)
from repro_torch.training.losses import (  # noqa: F401
    lm_loss, chunked_cross_entropy)
from repro_torch.training.train_loop import (  # noqa: F401
    TrainState, make_train_step, train)
