"""Consumer models that train on the card from device-resident sampler
indices: a GPT-2-style decoder, a ViT, the train step and the whole-run
runners, and the conversion of the JAX package's flax parameters."""

from .convert import gpt_params_from_flax, vit_params_from_flax  # noqa: F401
from .gpt import GPTConfig, MiniGPT, forward, init_params  # noqa: F401
from .train import (  # noqa: F401
    create_state,
    demo_training_run,
    make_epoch_runner,
    make_mixture_run_runner,
    make_run_runner,
    make_train_step,
)
from .vit import (  # noqa: F401
    MiniViT,
    ViTConfig,
    demo_vit_run,
    init_vit_params,
    make_vit_train_step,
    vit_forward,
)
