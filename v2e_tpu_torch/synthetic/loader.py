"""Dynamic synthetic-input plugin loading (port of
v2e_tpu/synthetic/loader.py).

The reference resolves ``--synthetic_input scripts.moving_dot`` by importing
the module and instantiating the class with the module's basename
(v2e.py:170-204).  Same protocol here.  Reference-style module paths
(``scripts.X``) and the JAX package's (``v2e_tpu.synthetic.X``) map to the
bundled ``v2e_tpu_torch.synthetic.X`` generators, so a command line written
for either runs unchanged on the port and never imports the JAX package.
"""
from __future__ import annotations

import importlib
import logging
from typing import Type

logger = logging.getLogger(__name__)

_BUNDLED = {
    "moving_dot",
    "particles",
    "gradients",
    "spots",
    "barberpole",
    "single_linearly_moving_dot",
}


def load_synthetic_input(module_path: str) -> Type:
    """Import a synthetic-input class from a module path.

    The class must have the same name as the module's last component.
    """
    name = module_path.split(".")[-1]
    if name in _BUNDLED and module_path in (f"scripts.{name}", f"v2e_tpu.synthetic.{name}"):
        module_path = f"v2e_tpu_torch.synthetic.{name}"
    try:
        mod = importlib.import_module(module_path)
    except ImportError as e:
        raise ImportError(f"could not import synthetic input {module_path}: {e}") from e
    cls = getattr(mod, name, None)
    if cls is None:
        raise ImportError(
            f"module {module_path} has no class named {name} "
            "(the class must be named like the module)"
        )
    logger.info(f"loaded synthetic input class {name} from {module_path}")
    return cls
