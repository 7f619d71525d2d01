from .train_step import (AdamSchedule, TrainState,  # noqa: F401
                         create_train_state, discriminator_loss,
                         generator_loss, generator_outputs, make_train_step)
