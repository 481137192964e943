from .autoencoders import (
    AE_CLASSES,
    ContrastiveAutoencoder,
    DenoisingAutoencoder,
    VariationalAutoencoder,
    build_autoencoder,
    encode_latents,
    init_autoencoder,
)
from .convert import (
    autoencoder_state_dict_from_jax,
    load_autoencoder_pth,
    minilm_params_from_state_dict,
    minilm_state_dict_from_jax,
)

__all__ = [
    "AE_CLASSES",
    "ContrastiveAutoencoder",
    "DenoisingAutoencoder",
    "VariationalAutoencoder",
    "build_autoencoder",
    "encode_latents",
    "init_autoencoder",
    "autoencoder_state_dict_from_jax",
    "load_autoencoder_pth",
    "minilm_params_from_state_dict",
    "minilm_state_dict_from_jax",
]
