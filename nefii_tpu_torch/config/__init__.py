"""The port's conf handling: its own copy of the HOCON parser and the class
alias table (counterpart of nefii_tpu/config)."""

from nefii_tpu_torch.config.hocon import ConfigFactory, ConfigTree, parse_file, parse_string
from nefii_tpu_torch.config.registry import get_class

__all__ = ["ConfigFactory", "ConfigTree", "parse_file", "parse_string", "get_class"]
