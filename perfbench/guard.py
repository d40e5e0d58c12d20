"""The check that nothing a run loads is JAX or the JAX package.

Names are compared whole, by the part before the first dot:
``skypilot_tpu_torch`` is the port and passes; ``skypilot_tpu`` does not.
"""
from __future__ import annotations

import sys
from typing import Iterable, List

FORBIDDEN = ('jax', 'jaxlib', 'flax', 'skypilot_tpu')


def forbidden_loaded(names: Iterable[str] = None) -> List[str]:
    names = list(sys.modules) if names is None else names
    found = {n.split('.', 1)[0] for n in names}
    return sorted(found & set(FORBIDDEN))


def quiet_env(env):
    """Keep libraries that would load JAX by themselves from doing so."""
    env.setdefault('USE_FLAX', '0')
    env.setdefault('USE_JAX', '0')
    env.setdefault('USE_TF', '0')
    return env
