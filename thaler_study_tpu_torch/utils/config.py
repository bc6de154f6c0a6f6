"""Framework configuration.

Counterpart of ``thaler_study_tpu/utils/config.py``: one frozen dataclass,
overridable per call (:class:`use_config`) and through ``THALER_*``
environment variables (:meth:`FrameworkConfig.from_env`), read once at
import. The names are kept so that code written against the reference's
``utils`` runs unchanged; the port reads no knob of it, so the dataclass
has no fields:

- the field is an explicit argument of every entry point of the port
  (the reference's ``field_name`` / ``THALER_FIELD`` is read by no module
  of either package);
- the PCS Merkle tree is built where its caller's ``device`` says
  (``pcs/merkle.py``: the kernel takes any leaf count), so the reference's
  ``merkle_device_min_leaves`` has nothing to choose;
- the mesh layout (``mesh_axis``, ``shard_vars``): the port's sharded
  entry points take ``n_shard`` as an argument (default log2 of the mesh
  size) and shard over every mesh axis, the A/B switches of kernel formulations (``use_pallas``,
  ``pallas_min_vars``, ``gkr_device_tables``, ``gkr_scatter_mode``: the
  port has one kernel per step) and the JAX compile cache
  (``compile_cache_dir``, ``apply_jax_config``) stay in the reference.
"""

from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class FrameworkConfig:
    """Global knobs for the prover runtime (none that the port reads)."""

    @classmethod
    def from_env(cls) -> "FrameworkConfig":
        """Environment overrides: no ``THALER_*`` variable applies to the port."""
        return cls()


DEFAULT = FrameworkConfig()

# The active config: the single source of truth the modules consult,
# initialized from the environment once at import and changed explicitly
# with set_config() / use_config().
_active: FrameworkConfig = FrameworkConfig.from_env()


def get_config() -> FrameworkConfig:
    """The currently active framework configuration."""
    return _active


def set_config(cfg: FrameworkConfig) -> FrameworkConfig:
    """Install ``cfg`` as the active configuration; returns the previous one."""
    global _active
    prev = _active
    _active = cfg
    return prev


class use_config:
    """Context manager scoping an active-config override."""

    def __init__(self, cfg: FrameworkConfig):
        self.cfg = cfg
        self._prev: Optional[FrameworkConfig] = None

    def __enter__(self) -> FrameworkConfig:
        self._prev = set_config(self.cfg)
        return self.cfg

    def __exit__(self, *exc) -> None:
        assert self._prev is not None
        set_config(self._prev)
