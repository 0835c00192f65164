from red_diffeq_tpu_torch.config.config_utils import (
    ConfigDict, load_config, print_config, save_config, update_config,
)
from red_diffeq_tpu_torch.config.default_config import (
    get_config, get_marmousi_config,
)

__all__ = [
    'ConfigDict', 'get_config', 'get_marmousi_config',
    'load_config', 'save_config', 'update_config', 'print_config',
]
