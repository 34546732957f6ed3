"""Algorithm 1's big-move rounds with the torus EGNN conditioner
(``net_type="gnn"``): the loop, the window, the traced chunk and the check
of ``rounds.py``, with the gnn's weights (``gnn_weights.py``) and its
plain reference (``reference/egnn.py``) in place of the other nets'.

The traced chunk's ``info`` also holds ``gnn_messages``: the messages the
program's ``TorusEGNN`` counted (``flows/nets.py::GNN_MESSAGES``) over
the chunk, None where the program has no such counter; the notes give
them a round.  ``control="bf16"``, the residual net's own lower
precision, is refused.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch

from benchmark import gnn_weights
from benchmark.drivers import rounds
from benchmark.reference import egnn as ref_egnn


@contextlib.contextmanager
def _gnn_weights():
    """``rounds.Session`` building its flow with the gnn's tree."""
    original = rounds.bench_weights
    rounds.bench_weights = gnn_weights
    try:
        yield
    finally:
        rounds.bench_weights = original


def _messages():
    """The program's count of the EGNN's messages, or None."""
    from flowstate_tpu_torch.flows import nets

    return getattr(nets, "GNN_MESSAGES", None)


class Session(rounds.Session):
    def __init__(self, config: dict, traffic: dict, seed: int, device,
                 control=None):
        if control == "bf16":
            raise ValueError("the gnn has no bfloat16 option; bf16 is the "
                             "residual net's")
        with _gnn_weights():
            super().__init__(config, traffic, seed, device, control)

    def traced(self) -> tuple:
        before = _messages()
        info, tr = super().traced()
        after = _messages()
        info["gnn_messages"] = (None if before is None or after is None
                                else after - before)
        self.notes["gnn_messages_per_round"] = (
            None if info["gnn_messages"] is None
            else info["gnn_messages"] / self.rounds)
        return info, tr

    def _logq(self, params, x) -> np.ndarray:
        """The reference's float64 log q of ``x``, in blocks of rows."""
        f, block = self.flow_cfg, self.traffic["check"]["block"]
        with torch.no_grad():
            return np.concatenate([ref_egnn.log_prob(
                params, x[i:i + block].double(), self.cfg.half_box,
                f["hidden_units"], f["num_bins"]).cpu().numpy()
                for i in range(0, len(x), block)])
