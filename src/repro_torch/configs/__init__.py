from repro_torch.configs.base import ArchConfig, get_config, smoke_config  # noqa: F401
