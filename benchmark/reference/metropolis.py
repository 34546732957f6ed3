"""The move kernel's random stream and a replay of its moves, and the
independence move's Metropolis-Hastings verdict.

The program documents the stream of its move kernel (K1): the randoms of
move t of chain c in the launch that a chain state's ``calls`` counter
names come from Philox4x32-10 (Salmon et al., SC'11) with key
``(seed mod 2^32, c)`` and counter ``(t, calls, 0, 0)``; its four words
give the particle ``x mod N``, the two displacement uniforms and the
acceptance uniform, each ``(w >> 8) / 2^24``.  A move displaces the
particle by ``(u - 1/2) max_disp`` per axis, wraps it into [0, L), and is
taken if ``dE <= 0`` or ``u < exp(-beta dE)``.

``replay`` follows chains through one launch from the benchmark's seed.
The program keeps positions in float32, so the replay does too: a
displaced position is ``x + (u - 1/2) max_disp`` rounded once to float32
(the kernel's fused multiply-add) and wrapped in float32; the energies
are float64 of those positions.  A move whose decision lies within
rounding of a tie marks its chain, whose later path the program's
float32 energies and the replay's may take apart.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from benchmark.reference.system import (
    CUTOFF, HARD_CORE, System, lj, min_image, well_energy,
)

_M0, _M1 = np.uint64(0xD2511F53), np.uint64(0xCD9E8D57)
_W0, _W1 = np.uint64(0x9E3779B9), np.uint64(0xBB67AE85)
_MASK = np.uint64(0xFFFFFFFF)
# a decision is a tie where |u - min(1, exp(-beta dE))| is under this:
# float32 energy changes of this system carry a few 1e-6 of rounding
TIE_U = 5e-5


def philox4x32_10(ctr, key):
    """Philox4x32-10 of uint32 counters ``ctr`` (4, ...) and keys
    ``key`` (2, ...), broadcast together; returns the four words."""
    x = [np.asarray(c, dtype=np.uint64) & _MASK for c in ctr]
    k0 = np.asarray(key[0], dtype=np.uint64) & _MASK
    k1 = np.asarray(key[1], dtype=np.uint64) & _MASK
    for _ in range(10):
        p0 = _M0 * x[0]
        p1 = _M1 * x[2]
        hi0, lo0 = p0 >> np.uint64(32), p0 & _MASK
        hi1, lo1 = p1 >> np.uint64(32), p1 & _MASK
        x = [hi1 ^ x[1] ^ k0, lo1, hi0 ^ x[3] ^ k1, lo0]
        k0 = (k0 + _W0) & _MASK
        k1 = (k1 + _W1) & _MASK
    return x


def draws(seed: int, chains: np.ndarray, calls: int, moves: int, n: int):
    """``(particle, u_x, u_y, u_accept)``, each (len(chains), moves), of
    the launch numbered ``calls``."""
    t = np.arange(moves, dtype=np.uint64)[None, :]
    c = np.asarray(chains, dtype=np.uint64)[:, None]
    w = philox4x32_10((t, np.uint64(calls), np.uint64(0), np.uint64(0)),
                      (np.uint64(seed), c))
    u = [(wi >> np.uint64(8)).astype(np.float64) / 16777216.0 for wi in w[1:]]
    return (w[0] % np.uint64(n)).astype(np.int64), u[0], u[1], u[2]


def _particle_energy(sys: System, pos: torch.Tensor, p: torch.Tensor,
                     xy: torch.Tensor) -> torch.Tensor:
    """The energy of particle ``p[b]`` at ``xy[b]`` against the others of
    ``pos[b]`` and the wells; infinite on an overlap."""
    b, n = pos.shape[:2]
    d = min_image(xy[:, None, :] - pos, sys.box)
    r2 = (d * d).sum(-1)
    other = torch.arange(n)[None, :] != p[:, None]
    e, _ = lj(r2)
    e = torch.where(other & (r2 <= CUTOFF ** 2), e, torch.zeros_like(e))
    overlap = (other & (r2 < HARD_CORE ** 2)).any(-1)
    energy = e.sum(-1) + well_energy(sys, xy)
    return torch.where(overlap, torch.full_like(energy, math.inf), energy)


def replay(sys: System, seed: int, chains: np.ndarray, calls: int,
           moves: int, positions: np.ndarray, max_disp: np.ndarray,
           store=torch.float32, compute=torch.float64):
    """One launch of ``moves`` moves of ``chains`` (their global indices)
    from ``positions`` (B, N, 2) with displacements ``max_disp`` (B,), on
    the CPU, positions held in ``store`` and energies computed in
    ``compute``.  Returns ``(positions (B, N, 2) float64, tie (B,) bool:
    a decision within rounding of a tie)``."""
    p_all, ux, uy, ua = draws(seed, chains, calls, moves, sys.n)
    pos = torch.as_tensor(positions, dtype=torch.float64).to(store).clone()
    md = torch.as_tensor(max_disp, dtype=torch.float64).to(store).to(compute)
    b = pos.shape[0]
    rows = torch.arange(b)
    tie = torch.zeros(b, dtype=torch.bool)
    box = torch.tensor(sys.box, dtype=torch.float64).to(store)
    inv_box = torch.tensor(1.0 / sys.box, dtype=torch.float64).to(store)
    for t in range(moves):
        p = torch.as_tensor(p_all[:, t])
        old = pos[rows, p]
        step = torch.stack([torch.as_tensor(ux[:, t]), torch.as_tensor(uy[:, t])],
                           -1).to(compute) - 0.5
        new = (old.to(compute) + step * md[:, None]).to(store)
        new = new - box * torch.floor(new * inv_box)
        here = pos.to(compute)
        de = (_particle_energy(sys, here, p, new.to(compute))
              - _particle_energy(sys, here, p, old.to(compute))).double()
        u = torch.as_tensor(ua[:, t])
        ratio = torch.exp(torch.clamp(-sys.beta * de, max=0.0))
        accept = (de <= 0.0) | (u < ratio)
        tie |= (u - ratio).abs() < TIE_U
        pos[rows, p] = torch.where(accept[:, None], new, old)
    return pos.double().numpy(), tie.numpy()


def position_gap(a: np.ndarray, b: np.ndarray, box: float) -> np.ndarray:
    """Per configuration, the largest minimum-image distance between the
    same particle in ``a`` and ``b`` (B, N, 2)."""
    d = a.astype(np.float64) - b.astype(np.float64)
    d = d - box * np.round(d / box)
    return np.sqrt((d * d).sum(-1)).max(-1)


def log_ratio(beta: float, e_new, e_old, logq_new, logq_old):
    """The independence move's ``log A = -beta (U_new - U_old) +
    log q(x_old) - log q(x_new)``."""
    return -beta * (e_new - e_old) + logq_old - logq_new
