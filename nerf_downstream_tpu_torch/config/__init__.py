"""Gin-compatible configuration engine.

The reference drives every run through gin-config: ``--ginc`` config files
(last-wins merge) plus ``--ginb`` bindings that win over files
(reference: co3d_3d/train.py:199-239, co3d_3d/README.md:35-46). The reference
also reflects on config state at runtime via ``gin.query_parameter``
(reference: co3d_3d/src/modules/optim.py:106-110, eval.py:164-165).

This module re-implements that contract from scratch (gin itself is not a
dependency): a ``configurable`` decorator, a parser for the ``name.param =
<python literal>`` statement language used by all 124 reference config files
(including multi-line lists/tuples, comments, ``@reference`` and ``%macro``
syntax), ``parse_config_files_and_bindings``, ``query_parameter``, and an
operative-config dump for logging.
"""

from nerf_downstream_tpu_torch.config.engine import (
    ConfigError,
    bind,
    check_bindings,
    clear_config,
    config_str,
    configurable,
    constant,
    external_configurable,
    get_configurable,
    operative_config_str,
    parse_config,
    parse_config_files_and_bindings,
    query_parameter,
    register,
)

__all__ = [
    "ConfigError",
    "bind",
    "check_bindings",
    "clear_config",
    "config_str",
    "configurable",
    "constant",
    "external_configurable",
    "get_configurable",
    "operative_config_str",
    "parse_config",
    "parse_config_files_and_bindings",
    "query_parameter",
    "register",
]
