"""Weight bridge: the reference package's classifier parameters, already
converted to numpy by the caller, as the port's tensors.

The tree is ``{"encoder": [LSTMParams(wx [4,I,H], wh [4,H,H], b [4,H]),
...], "head": DenseParams(w [H,C], b [C])}`` with numpy leaves (any
NamedTuple or plain tuple in that field order).  Layouts are unchanged: the
port's public functions take the reference's layouts.  Nothing here imports
jax; the caller does the ``np.asarray`` on its side.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core.cells import LSTMParams
from repro_torch.core.linear import DenseParams


def _tensor(a, device) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32)).to(device)


def from_numpy_params(tree, device=None) -> dict:
    """Classifier params as port tensors on ``device`` (default CUDA)."""
    dev = resolve_device(device)
    encoder = [LSTMParams(*(_tensor(a, dev) for a in layer))
               for layer in tree["encoder"]]
    w, b = tree["head"]
    return {"encoder": encoder,
            "head": DenseParams(_tensor(w, dev), _tensor(b, dev))}
