"""The converted pretrained bundle (counterpart of
``megaportraits_tpu/utils/pretrained.py``).

The JAX package keeps the frozen loss backbones, SixDRepNet and the
resnet18 trunks as an Orbax bundle (``scripts/convert_weights.py``) and
grafts it into the model variables. The port has no loader for that bundle
yet: it reports what JAX reports when there is nothing to load, and raises
when a bundle is there, so that a run never trains on random weights that
were meant to be pretrained.
"""

from __future__ import annotations

import os


def _holds_bundle(path: str) -> bool:
    """Whether `path` holds a bundle as JAX's ``load_bundle`` finds one: a
    directory with an Orbax step in it, a subdirectory named by an
    integer. Checked without importing Orbax."""
    path = os.path.abspath(path)
    if not os.path.isdir(path):
        return False
    return any(name.isdigit() and os.path.isdir(os.path.join(path, name))
               for name in os.listdir(path))


def pretrained_report(path: str) -> str:
    """JAX ``maybe_load_pretrained``'s report, word for word, for the cases
    the port can meet: 'pretrained: none' for an empty path and
    'pretrained: no bundle at <path>' where nothing is. Raises
    NotImplementedError where a bundle is."""
    if not path:
        return "pretrained: none"
    if not _holds_bundle(path):
        return f"pretrained: no bundle at {path}"
    raise NotImplementedError(
        f"a pretrained bundle is at {path}, and the port has no loader for it "
        "yet; set training.pretrained_path to '' to train on random weights")
