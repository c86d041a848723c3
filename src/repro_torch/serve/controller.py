"""The data plane of a live reconfiguration — port of the parts of
``repro.serve.controller`` that ``FleetEngine.reconfigure_tenant`` runs.

A reconfiguration swaps a tenant to a new :class:`ServingConfig` (S chains,
serving precision, launch-shape budget) at a tick boundary, sessions
intact: each session's carry is converted (:func:`convert_session`) into
the dtypes the new engine stores (:func:`carry_dtypes`) and re-attached on
the same ``(seed, rows)`` mask coordinates, so the Bayesian draw goes on.

The control plane that decides when and what to swap (``SLOPolicy``,
``KnobSpace``, ``DecisionRecord``, ``CoDesignController``,
``FleetController``) is not ported yet (ROADMAP A7), nor are the knobs only
it reads: the quality rank (``PRECISION_RANK``, ``ServingConfig.quality``)
waits for it, and ``shards`` for the mesh (A8).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.kernels import quantize as _quant
from repro_torch.serve.sessions import Session

@dataclasses.dataclass(frozen=True)
class ServingConfig:
    """The live-reconfigurable knobs.

    ``chunk_capacity`` is the launch-shape budget (the top ladder rung; 0 =
    keep the tenant's own).  H, NL, placement and cell change the
    parameters themselves: a deploy, not a reconfiguration.
    """

    n_samples: int
    precision: str | None = None
    chunk_capacity: int = 0


def carry_dtypes(cell: str, precision: str | None, backend: str,
                 chunk_dtype=torch.float32) -> tuple:
    """Per-part carry dtypes an engine stores its sessions in.

    As ``StreamingEngine._gather_states``: h in the serving precision's
    activation dtype, the LSTM's c in fp32 (in the activation dtype on the
    ``reference`` backend at native precision).  A carry converted to
    them is what the new engine's graphs take; the conversion is the
    numeric boundary of a precision swap (an fp32 → bf16 downshift rounds
    the carry once).
    """
    h_dt = _quant.activation_dtype(precision, chunk_dtype)
    if precision is not None:
        c_dt = torch.float32
    else:
        c_dt = chunk_dtype if backend == "reference" else torch.float32
    return (h_dt,) if cell == "gru" else (h_dt, c_dt)


def convert_session(sess: Session, *, n_samples: int, part_dtypes: tuple,
                    extra_rows: np.ndarray | None = None) -> Session:
    """Re-shape one session's carry for a new (S, precision) config.

    Chains are independent trajectories, so a downshift keeps the first
    ``n_samples`` chains bit-exactly; an upshift appends fresh chains (zero
    carry, the newly allocated ``extra_rows``) that join the draw at the
    swap.  The carry stays on its device: a slice, a cast to
    ``part_dtypes`` and, on an upshift, zero rows made there.  Rows stay
    host ``np.uint32``; cursors and sid are kept; the session comes back
    in the default mode, as the reference's does.
    """
    rows = np.asarray(sess.rows, np.uint32)
    s_old = int(rows.shape[0])
    if n_samples <= s_old:
        new_rows = rows[:n_samples].copy()
    else:
        if extra_rows is None or len(extra_rows) != n_samples - s_old:
            raise ValueError(
                f"upshift {s_old}→{n_samples} needs {n_samples - s_old} "
                "freshly-allocated extra_rows")
        new_rows = np.concatenate([rows, np.asarray(extra_rows, np.uint32)])
    state = None
    if sess.state is not None:
        state = []
        for layer in sess.state:
            parts = []
            for part, dt in zip(layer, part_dtypes):
                p = part[:min(s_old, n_samples)].to(dt)
                if n_samples > s_old:
                    p = torch.cat([p, torch.zeros(
                        (n_samples - s_old, p.shape[-1]), dtype=dt,
                        device=p.device)])
                parts.append(p)
            state.append(tuple(parts))
    return Session(sid=sess.sid, rows=new_rows, seed=sess.seed, state=state,
                   steps=sess.steps, chunks=sess.chunks)
