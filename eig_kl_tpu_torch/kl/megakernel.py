"""The KL pass: kernel K2 (``csrc/kl_pass.cu``), its plain version, and
the refinement and fused pipelines around it (the port of
``eig_kl_tpu/kl/megakernel.py``).

One pass runs in one launch, as the TPU mega-kernel does
(``megakernel.py:_kernel``, ``:144``).  Per swap: the first maximum of
``D = -(sf * a_s)`` over each side (``sf`` = side sign * free), the two
row updates of the cached ``a_s = A @ s``, the lock, the gain
``D_a + D_b - 2 w_ab`` added into a Kahan-compensated cut, the four swap
logs, and the termination rule (``floor(log2 n) + 5`` consecutive swaps
with ``gain <= gain_eps``, cKL.cpp:303,382-386).  Around the pass: the
initial ``A @ s`` and cut, and afterwards the replay of the final and
best partitions from the swap log and the from-scratch recount
(``megakernel.py:_finalize_batch``, ``:710``).
"""

from __future__ import annotations

import ctypes
import dataclasses

import numpy as np
import torch

from eig_kl_tpu_torch.graph.csr import DeviceGraph
from eig_kl_tpu_torch.io.eigfile import EigResult
from eig_kl_tpu_torch.kl.result import KLResult
from eig_kl_tpu_torch.ops._build import Kernel
from eig_kl_tpu_torch.ops.partition import cut_size, sides_to_signs
from eig_kl_tpu_torch.ops.select import upper_median
from eig_kl_tpu_torch.ops.spmv import spmv
from eig_kl_tpu_torch.utils.config import KLConfig, SpectralConfig
from eig_kl_tpu_torch.utils.tracing import Tracer

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
K2 = Kernel(
    "kl_pass",
    "kl_pass_f32",
    [_P, _P, _P, _P, _P, _I, _F, _I, _I, _F, _P, _P, _P, _P, _P, _P],
)


@dataclasses.dataclass(frozen=True)
class PassOutput:
    """What one KL pass returns, on the pass's device.

    Attributes:
      sf: float[n] final side sign * free (0 = locked).
      log_cut, log_gain: float[cap + 1]; entry 0 is the initial cut and
        0, entries 1..iterations the cut and gain after each swap.
      log_a, log_b: int32[cap + 1]; entries 1..iterations the swapped
        pair (a left side 0, b left side 1).
      scalars: float[8], the TPU kernel's ``out_ref`` (megakernel.py:486-494):
        cut, best cut, iterations, termination count, free nodes on
        side 0 and on side 1, initial cut, stop flag.
    """

    sf: torch.Tensor
    log_cut: torch.Tensor
    log_gain: torch.Tensor
    log_a: torch.Tensor
    log_b: torch.Tensor
    scalars: torch.Tensor


def kl_pass_plain(
    g: DeviceGraph,
    sf0: torch.Tensor,
    as0: torch.Tensor,
    cut0: float,
    cap: int,
    terminate_limit: int,
    gain_eps: float,
) -> PassOutput:
    """One KL pass as a Python loop of PyTorch ops, in ``sf0``'s dtype.

    The same arithmetic as K2, operation for operation: selection and row
    updates run on ``sf0``'s device, the scalar bookkeeping runs on the
    host in NumPy scalars of the same dtype.  ``torch.argmax`` returns the
    first maximum, and counts -0.0 and +0.0 as equal, as K2 does.
    """
    dtype = sf0.dtype
    t = torch.empty(0, dtype=dtype).numpy().dtype.type
    log_len = cap + 1
    sf, a_s = sf0.clone(), as0.clone()
    indptr = g.indptr.cpu().numpy()
    indices = g.indices.cpu().numpy()
    data = g.data.to(dtype)
    data_h = data.cpu().numpy()
    log_cut = np.zeros(log_len, dtype=t)
    log_gain = np.zeros(log_len, dtype=t)
    log_a = np.zeros(log_len, dtype=np.int32)
    log_b = np.zeros(log_len, dtype=np.int32)
    cut = best = log_cut[0] = t(cut0)
    comp, two, eps = t(0.0), t(2.0), t(gain_eps)
    nf0, nf1 = int((sf > 0).sum()), int((sf < 0).sum())
    it = term = stop = 0
    while stop == 0 and it < cap and nf0 > 0 and nf1 > 0:
        d = -(sf * a_s)
        dl = torch.where(sf > 0, d, -torch.inf)
        dr = torch.where(sf < 0, d, -torch.inf)
        am = torch.stack([torch.argmax(dl), torch.argmax(dr)])
        picked = torch.cat([am.double(), torch.stack([dl[am[0]], dr[am[1]]]).double()])
        a, b, m_l, m_r = picked.tolist()  # one device read per swap
        a, b, m_l, m_r = int(a), int(b), t(m_l), t(m_r)

        # Row a, then row b.  a is on side 0 and b on side 1, so their
        # signs are +1 and -1 and the coefficients -2*s are -2 and +2.
        lo, hi = indptr[a], indptr[a + 1]
        a_s.index_add_(0, g.indices[lo:hi].long(), -2.0 * data[lo:hi])
        row = indices[lo:hi]
        w_ab = data_h[lo:hi][row == b].sum(dtype=t)
        lo, hi = indptr[b], indptr[b + 1]
        a_s.index_add_(0, g.indices[lo:hi].long(), 2.0 * data[lo:hi])
        sf[a] = 0.0
        sf[b] = 0.0

        gain = (m_l + m_r) - two * w_ab
        y = -gain - comp  # Kahan-compensated cut (megakernel.py:424-431)
        tot = cut + y
        comp = (tot - cut) - y
        cut = tot
        best = min(cut, best)
        it += 1
        log_cut[it], log_gain[it], log_a[it], log_b[it] = cut, gain, a, b
        term = term + 1 if gain <= eps else 0
        stop = int(term > terminate_limit)
        nf0 -= 1
        nf1 -= 1
    scalars = np.array([cut, best, it, term, nf0, nf1, t(cut0), stop], dtype=t)
    dev = sf0.device
    return PassOutput(
        sf=sf,
        log_cut=torch.as_tensor(log_cut).to(dev),
        log_gain=torch.as_tensor(log_gain).to(dev),
        log_a=torch.as_tensor(log_a).to(dev),
        log_b=torch.as_tensor(log_b).to(dev),
        scalars=torch.as_tensor(scalars).to(dev),
    )


def kl_pass_cuda(
    g: DeviceGraph,
    sf0: torch.Tensor,
    as0: torch.Tensor,
    cut0: float,
    cap: int,
    terminate_limit: int,
    gain_eps: float,
) -> PassOutput:
    """Launch K2 on the current stream: one block of 1,024 threads runs
    the whole pass.  Inputs are f32 on the card; they are not modified."""
    n = g.num_nodes
    dev = sf0.device
    if dev.type != "cuda" or as0.device != dev or g.device != dev:
        raise ValueError("kl_pass_cuda needs sf0, as0 and the graph on one CUDA device")
    if sf0.dtype != torch.float32 or as0.dtype != torch.float32 or g.dtype != torch.float32:
        raise TypeError(
            "the card's KL pass is float32 only (an f64 engine on the card is "
            "ROADMAP.md A9)"
        )
    if sf0.shape != (n,) or as0.shape != (n,):
        raise ValueError(f"sf0 and as0 must be ({n},) vectors")
    log_len = cap + 1
    padded = -(-n // 4) * 4  # the scan reads float4s; padding has sf = 0
    sf = torch.zeros(padded, dtype=torch.float32, device=dev)
    a_s = torch.zeros(padded, dtype=torch.float32, device=dev)
    sf[:n] = sf0
    a_s[:n] = as0
    log_cut = torch.zeros(log_len, dtype=torch.float32, device=dev)
    log_gain = torch.zeros_like(log_cut)
    log_a = torch.zeros(log_len, dtype=torch.int32, device=dev)
    log_b = torch.zeros_like(log_a)
    log_cut[0] = cut0
    scalars = torch.empty(8, dtype=torch.float32, device=dev)
    K2(
        g.indptr.data_ptr(),
        g.indices.data_ptr(),
        g.data.data_ptr(),
        sf.data_ptr(),
        a_s.data_ptr(),
        padded,
        cut0,
        cap,
        terminate_limit,
        gain_eps,
        log_cut.data_ptr(),
        log_gain.data_ptr(),
        log_a.data_ptr(),
        log_b.data_ptr(),
        scalars.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    return PassOutput(sf[:n], log_cut, log_gain, log_a, log_b, scalars)


def kl_pass(g, sf0, as0, cut0, cap, terminate_limit, gain_eps) -> PassOutput:
    """One KL pass: K2 for tensors on the card, the plain version for
    tensors on the CPU."""
    fn = kl_pass_plain if sf0.device.type == "cpu" else kl_pass_cuda
    return fn(g, sf0, as0, cut0, cap, terminate_limit, gain_eps)


def natural_cap(num_nodes: int, n1: int, config: KLConfig) -> int:
    """Swap cap: the smaller side (KL's exhaustion point), or
    ``max_iterations`` if that is smaller (megakernel.py:1403-1413)."""
    natural = min(num_nodes - n1, n1)
    if config.max_iterations is None:
        return natural
    return min(config.max_iterations, natural)


def _refine(
    g: DeviceGraph, sides: torch.Tensor, config: KLConfig, tracer: Tracer
) -> KLResult:
    """Initial ``A @ s`` and cut, one pass, then finalization: the replay
    of the final and best partitions from the swap log (side(a) -> 1,
    side(b) -> 0; the best is the first minimum of the cut log) and the
    from-scratch recount (the gKL.cu:524-530 oracle)."""
    if config.refresh_interval > 0:
        raise NotImplementedError(
            "refresh_interval is not yet ported to eig_kl_tpu_torch "
            "(ROADMAP.md A3)"
        )
    n = g.num_nodes
    with tracer.span("kl.pass"):
        cap = natural_cap(n, int(sides.to(torch.int64).sum()), config)
        s = sides_to_signs(sides, g.dtype)
        a_s = spmv(g, s)
        cut0 = float(cut_size(g, s, a_s))
        out = kl_pass(g, s, a_s, cut0, cap, config.terminate_limit(n), config.gain_eps)

    with tracer.span("kl.finalize"):
        sc = out.scalars.cpu().numpy()
        it = int(sc[2])
        log_cut = out.log_cut[: it + 1]
        best_it = int(torch.argmin(log_cut))  # first minimum

        def replay(upto: int) -> torch.Tensor:
            r = sides.clone()
            r[out.log_a[1 : upto + 1].long()] = 1
            r[out.log_b[1 : upto + 1].long()] = 0
            return r

        final = replay(it)
        verified = cut_size(g, sides_to_signs(final, g.dtype))
        result = KLResult(
            sides=final.cpu().numpy(),
            best_sides=replay(best_it).cpu().numpy(),
            initial_cut=float(sc[6]),
            final_cut=float(sc[0]),
            best_cut=float(sc[1]),
            verified_cut=float(verified),
            iterations=it,
            cut_trajectory=log_cut.cpu().numpy(),
            gain_trajectory=out.log_gain[: it + 1].cpu().numpy(),
        )
    return result


def refine_mega(
    g: DeviceGraph,
    sides: np.ndarray,
    config: KLConfig = KLConfig(),
    *,
    tracer: Tracer | None = None,
) -> KLResult:
    """One KL pass from the int8[n] side labels ``sides``, on the graph's
    device; host-side result.  ``tracer`` receives the spans "kl.pass"
    and "kl.finalize"."""
    sides_t = torch.as_tensor(np.asarray(sides, dtype=np.int8)).to(g.device)
    return _refine(g, sides_t, config, tracer or Tracer(g.device))


def fused_refine_mega(
    g: DeviceGraph,
    spectral_config: SpectralConfig,
    config: KLConfig = KLConfig(),
    *,
    tracer: Tracer | None = None,
):
    """The whole gKL2 pipeline on the graph's device: power solve,
    "upper"-median split (gKL2.cu:403-414), one KL pass, finalization.
    The split stays on the device between the phases.  ``tracer``
    receives the spans "spectral", "kl.pass" and "kl.finalize".

    Returns ``(EigResult, KLResult, power iterations)``.
    """
    from eig_kl_tpu_torch.spectral.power import _power_core

    tracer = tracer or Tracer(g.device)
    with tracer.span("spectral"):
        lam, v, iters = _power_core(
            g,
            shift=spectral_config.shift,
            tolerance=spectral_config.tolerance,
            min_iters=spectral_config.min_power_iters,
            max_iters=spectral_config.max_iterations,
            seed=spectral_config.seed,
            dtype=g.dtype,
            convergence=spectral_config.convergence,
            check_interval=spectral_config.check_interval,
            stable_checks=spectral_config.stable_checks,
        )
        med = upper_median(v)
        sides = (med > v).to(torch.int8)
    kl = _refine(g, sides, config, tracer)
    eig = EigResult(
        eigenvalue=float(lam),
        median=float(med),
        sides=sides.cpu().numpy(),
        values=v.double().cpu().numpy(),
    )
    return eig, kl, iters
