from .dims import PRESET_DIMS, ModelDimensions  # noqa: F401
from .registry import (  # noqa: F401
    WhisperModel,
    available_models,
    checkpoint_dict,
    from_random,
    load_model,
    state_dict_from_jax_params,
)
from . import whisper  # noqa: F401
