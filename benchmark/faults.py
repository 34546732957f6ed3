"""Faults planted in the program for the check's readings: each wraps
one of the program's functions for the length of a ``with`` block, so
that a run with the fault shows whether ``correct`` catches it.

* ``frozen``: the move kernel (K1) returns its input positions;
* ``half``: K1 moves the first half of the chains only;
* ``altered_positions``: K1 shifts particle 0 of every 8th chain by 0.25;
* ``altered_energy``: the pair-energy kernel's (K2) resync adds 0.5 to
  the energy of every 8th chain;
* ``altered_logq``: the flow's ``log_prob`` adds 0.05 to every 8th
  chain's log q;
* ``always_accept``, ``never_accept``: the big move's verdict takes
  every proposal whose ratio is above 0, or none (the uniforms replaced
  by 0 or 2);
* ``flipped_logq``: the big move's verdict takes the log q term with
  its sign flipped, ``log q(x_new) - log q(x_old)``.
"""

from __future__ import annotations

import contextlib

import torch

NAMES = ("frozen", "half", "altered_positions", "altered_energy",
         "altered_logq", "always_accept", "never_accept", "flipped_logq")
VERDICT = ("always_accept", "never_accept", "flipped_logq")


def _every_8th(t: torch.Tensor) -> torch.Tensor:
    return (torch.arange(t.shape[0], device=t.device) % 8 == 0)


def _k1_fault(name: str, k1):
    def moves(spec, beta, state, num_moves, *args, **kwargs):
        out = k1(spec, beta, state, num_moves, *args, **kwargs)
        pos = out.positions
        if name == "frozen":
            pos = state.positions.clone()
        elif name == "half":
            half = pos.shape[0] // 2
            pos = torch.cat([pos[:half], state.positions[half:]])
        else:
            shift = torch.zeros_like(pos)
            shift[:, 0, 0] = 0.25 * _every_8th(pos)
            pos = torch.remainder(pos + shift, spec.box.size_x)
        return out.replace(positions=pos.contiguous())

    return moves


def _verdict_fault(name: str, apply_big_moves):
    from flowstate_tpu_torch.mcmc.hybrid import to_centered

    def verdict(spec, beta, state, proposals, log_q_new, model, half_box,
                u, log_q_old=None):
        if name == "flipped_logq":
            if log_q_old is None:
                with torch.no_grad():
                    log_q_old = model.log_prob(to_centered(
                        state.positions, half_box).to(model.dtype))
            log_q_new, log_q_old = log_q_old, log_q_new
        elif name == "always_accept":
            u = torch.zeros_like(u)
        else:
            u = torch.full_like(u, 2.0)
        return apply_big_moves(spec, beta, state, proposals, log_q_new,
                               model, half_box, u, log_q_old)

    return verdict


@contextlib.contextmanager
def planted(name: str, device):
    """The program with fault ``name`` for the block."""
    from flowstate_tpu_torch.flows.core import NormalizingFlow
    from flowstate_tpu_torch.mcmc import cuda_metropolis as cm

    if name not in NAMES:
        raise ValueError(f"no fault {name!r}; the faults are {NAMES}")
    if name in VERDICT:
        from flowstate_tpu_torch.experiments import algorithm1

        target, attr = algorithm1, "apply_big_moves"
        original = algorithm1.apply_big_moves
        patched = _verdict_fault(name, original)
    elif name == "altered_logq":
        target, attr = NormalizingFlow, "log_prob"
        original = NormalizingFlow.log_prob

        def patched(self, x):
            return original(self, x) + 0.05 * _every_8th(x)
    elif name == "altered_energy":
        target, attr = cm, "resync_energy"
        original = cm.resync_energy

        def patched(spec, state):
            out = original(spec, state)
            return out.replace(energy=out.energy + 0.5 * _every_8th(out.energy))
    else:
        attr = ("run_moves_kernel" if torch.device(device).type == "cuda"
                else "run_moves_plain")
        target, original = cm, getattr(cm, attr)
        patched = _k1_fault(name, original)
    setattr(target, attr, patched)
    try:
        yield
    finally:
        setattr(target, attr, original)
