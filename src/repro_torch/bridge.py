"""Weight bridge: the reference package's model parameters, already
converted to numpy by the caller, as the port's tensors.

Two trees: the classifier's ``{"encoder": [...], "head": DenseParams(w [H,C],
b [C])}`` and the autoencoder's ``{"encoder": [...], "decoder": [...],
"head": DenseParams}``.  Each recurrent layer is a ``(wx [G,I,H], wh
[G,H,H], b [G,H])`` triple with numpy leaves (any NamedTuple or plain tuple
in that field order): ``GRUParams`` when the gate axis G is 3,
``LSTMParams`` when it is 4.  Layouts are unchanged: the port's public
functions take the reference's layouts.  Nothing here imports jax; the
caller does the ``np.asarray`` on its side.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core.cells import GRUParams, LSTMParams
from repro_torch.core.linear import DenseParams

_CELL_PARAMS = {3: GRUParams, 4: LSTMParams}


def _tensor(a, device) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32)).to(device)


def _layer(layer, device):
    wx, wh, b = (_tensor(a, device) for a in layer)
    try:
        kind = _CELL_PARAMS[wx.shape[0]]
    except KeyError:
        raise ValueError(f"a recurrent layer has 3 (GRU) or 4 (LSTM) gates, "
                         f"got wx of shape {tuple(wx.shape)}") from None
    return kind(wx, wh, b)


def from_numpy_params(tree, device=None) -> dict:
    """Classifier or autoencoder params as port tensors on ``device``
    (default CUDA)."""
    dev = resolve_device(device)
    out = {name: [_layer(layer, dev) for layer in tree[name]]
           for name in ("encoder", "decoder") if name in tree}
    w, b = tree["head"]
    out["head"] = DenseParams(_tensor(w, dev), _tensor(b, dev))
    return out
