"""Weight bridge: the reference package's model parameters, already
converted to numpy by the caller, as the port's tensors.

Recurrent models (:func:`from_numpy_params`) take two trees: the
classifier's ``{"encoder": [...], "head": DenseParams(w [H,C], b [C])}``
and the autoencoder's ``{"encoder": [...], "decoder": [...], "head":
DenseParams}``.  Each recurrent layer is a ``(wx [G,I,H], wh
[G,H,H], b [G,H])`` triple with numpy leaves (any NamedTuple or plain tuple
in that field order): ``GRUParams`` when the gate axis G is 3,
``LSTMParams`` when it is 4.  Layouts are unchanged: the port's public
functions take the reference's layouts.

A distilled student's heads (:func:`from_numpy_student`) take the
reference's ``{"head": DenseParams, "unc": DenseParams}`` with numpy
leaves.

The LM backbone (:func:`from_numpy_backbone`) takes the reference's
``backbone.init_params`` tree, whose stage leaves are stacked over repeats,
and unstacks it into the port's per-layer blocks, bf16 leaves as bf16.
The recurrent models' leaves become fp32.

Nothing here imports jax; the caller does the ``np.asarray`` on its side
(``jax.tree.map(np.asarray, params)`` keeps the NamedTuples and the
``None`` leaves).
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core.cells import GRUParams, LSTMParams
from repro_torch.core.linear import DenseParams
from repro_torch.models import backbone
from repro_torch.models.layers import AttnParams, EmbedParams, MLPParams
from repro_torch.models.mamba2 import MambaParams
from repro_torch.models.mla import MLAParams
from repro_torch.models.moe import MoEParams

_MIXER_PARAMS = {"attn": AttnParams, "enc_attn": AttnParams,
                 "dec_attn": AttnParams, "mla": MLAParams,
                 "mamba": MambaParams}

_CELL_PARAMS = {3: GRUParams, 4: LSTMParams}


def _tensor(a, device, keep_bf16: bool = False) -> torch.Tensor:
    """An fp32 tensor of ``a``; with ``keep_bf16`` a bfloat16 leaf (numpy's
    extension dtype named ``bfloat16``, found by its name) stays bfloat16,
    its bits taken as they are."""
    a = np.asarray(a)
    if keep_bf16 and a.dtype.name == "bfloat16":
        bits = np.array(a).view(np.int16)          # a writable copy
        return torch.from_numpy(bits).view(torch.bfloat16).to(device)
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


def from_numpy_student(tree, device=None) -> dict:
    """A student's two dense heads (``repro.core.distill.init_student``)
    as port tensors on ``device`` (default CUDA): ``{"head": DenseParams,
    "unc": DenseParams}``, fp32."""
    dev = resolve_device(device)
    return {name: DenseParams(*(_tensor(a, dev) for a in tree[name]))
            for name in ("head", "unc")}


def _leaves(kind, leaves, device, r=None):
    """A NamedTuple ``kind`` of port tensors from numpy leaves (``None``
    stays ``None``), taking repeat ``r`` of stacked leaves when given."""
    return kind(*(None if a is None else
                  _tensor(a if r is None else np.asarray(a)[r], device,
                          keep_bf16=True)
                  for a in leaves))


def _ffn(kind: str, leaves, device, r):
    """A block's FFN: ``MLPParams``, or ``MoEParams`` whose ``shared`` is
    an ``MLPParams`` of its own stacked leaves or None."""
    if kind.split(".")[-1] == "mlp":
        return _leaves(MLPParams, leaves, device, r)
    *arrays, shared = leaves[:4]
    return MoEParams(*(_tensor(np.asarray(a)[r], device, keep_bf16=True)
                       for a in arrays),
                     shared=(None if shared is None
                             else _leaves(MLPParams, shared, device, r)),
                     norm=_tensor(np.asarray(leaves[4])[r], device,
                                  keep_bf16=True))


def _stages(stages, tree_stages, device):
    """Stacked stages as the port's ``[[tuple of block dicts] per repeat]
    per stage``."""
    out = []
    for st, per_pos in zip(stages, tree_stages):
        out.append([tuple(
            {"mixer": _leaves(_MIXER_PARAMS[kind.split(".")[0]],
                              block["mixer"], device, r),
             **({"cross": _leaves(AttnParams, block["cross"], device, r)}
                if "cross" in block else {}),
             **({"ffn": _ffn(kind, block["ffn"], device, r)}
                if "ffn" in block else {})}
            for kind, block in zip(st.pattern, per_pos))
            for r in range(st.repeat)])
    return out


def from_numpy_backbone(tree, cfg, device=None) -> dict:
    """The reference's LM parameters as the port's ``backbone`` params.

    ``tree``: ``{"embed": (table, head, final_norm), "stages": [per stage, a
    tuple over pattern positions of {"mixer": AttnParams / MLAParams /
    MambaParams fields, "cross": AttnParams fields, "ffn": MLPParams /
    MoEParams fields} (a bare ``mamba`` block has no "ffn", only a
    ``.cross`` block has "cross"; a MoE's ``shared`` is MLPParams fields
    or None), each leaf stacked [repeat, ...]]}`` with numpy leaves, and
    for an encoder–decoder ``"encoder_stages"`` (the same nesting) and
    ``"encoder_norm"`` [D].  Returns ``{"embed": EmbedParams, "stages":
    [[tuple over pattern positions of block dicts] per repeat] per
    stage}`` (and ``"encoder_stages"``, ``"encoder_norm"``) on ``device``
    (default CUDA): a bfloat16 leaf stays bfloat16 (the reference builds
    its LMs in bf16), every other leaf is fp32 (the router among them).
    """
    backbone.check_cfg(cfg)
    dev = resolve_device(device)
    out = {"embed": _leaves(EmbedParams, tree["embed"], dev),
           "stages": _stages(cfg.stages, tree["stages"], dev)}
    if cfg.encoder_stages:
        out["encoder_stages"] = _stages(cfg.encoder_stages,
                                        tree["encoder_stages"], dev)
        out["encoder_norm"] = _tensor(tree["encoder_norm"], dev,
                                      keep_bf16=True)
    return out
