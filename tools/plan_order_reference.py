"""The port's own plain runs on the CPU of the paths that take a TPU
plan's order at gen 1.0x (seed 42, 201,920 nodes, 1,107,844 stored
entries, a v2 plan): the bits that ``chip_smoke.py`` holds the card's runs
of the same paths to.

Run from the repository root (several minutes on one thread)::

    python3 tools/plan_order_reference.py
    python3 tools/plan_order_reference.py --forms   # the v2 SpMV's other forms

With ``--forms`` it runs, instead, the plan path's one start under each of
the v2 SpMV's other forms that the environment picks, as a user sets them:
with bf16 products under ``EIG_KL_TPU_BF16_W=1`` (the plan's weights in
bf16), under ``EIG_KL_TPU_REDUCE_IMPL=vpu`` (the "vpu" reduce's order;
"mxu2" at gen 1.0x's row block of 16,384 is the default's order) and under
both, and with f32 products under ``EIG_KL_TPU_REDUCE_IMPL=vpu``.

It prints one JSON object: the plan's geometry; ``fused_refine_mega``
called directly (the JAX mega engine's program: the power solve on the CSR
state, then one KL pass whose starting ``A @ s`` and recount take the v2
order) with its power iterations, eigenvalue, initial cut, best cut, swaps,
final and verified cuts and the nodes on side 1 of the split; and the CSR
plan path's one-start run (``fused_partition(with_plan=True)``: the power
solve on the padded state with bf16 products, the KL pass's ``A @ s`` in
the v2 order in f32) with its power iterations, swaps and cuts.  The JAX
package cannot run these at this size on the CPU in interpret mode; its
kernels' order is held at smaller sizes by
``tests/test_torch_plan_order.py``.
"""

from __future__ import annotations

import json
import os
import sys
import time

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


#: The v2 SpMV's other forms that ``--forms`` runs: (name, products,
#: environment).
FORMS = (
    ("bf16i_bf16w", "bfloat16", {"EIG_KL_TPU_BF16_W": "1"}),
    ("bf16i_vpu", "bfloat16", {"EIG_KL_TPU_REDUCE_IMPL": "vpu"}),
    ("bf16i_bf16w_vpu", "bfloat16", {"EIG_KL_TPU_BF16_W": "1", "EIG_KL_TPU_REDUCE_IMPL": "vpu"}),
    ("f32_vpu", "float32", {"EIG_KL_TPU_REDUCE_IMPL": "vpu"}),
)


def plan_path_one_start(hg, inter: str = "bfloat16") -> dict:
    """The CSR plan path's one start (seed 42) on the CPU, its products in
    ``inter``."""
    from eig_kl_tpu_torch.models.pipelines import fused_partition
    from eig_kl_tpu_torch.utils.config import SpectralConfig

    t0 = time.perf_counter()
    r = fused_partition(hg, use_eig=True, device="cpu", with_plan=True,
                        spectral_config=SpectralConfig(solver="power", inter_dtype=inter))
    return {
        "iterations": r.spectral_iterations, "initial": r.kl.initial_cut, "best": r.kl.best_cut,
        "swaps": r.kl.iterations, "final": r.kl.final_cut, "verified": r.kl.verified_cut,
        "s": time.perf_counter() - t0,
    }


def forms() -> dict:
    from eig_kl_tpu_torch.models.generator import CircuitGenerator

    torch.set_num_threads(1)
    hg = CircuitGenerator(1.0, 42).generate()
    out = {}
    for name, inter, env in FORMS:
        saved = {k: os.environ.get(k) for k in env}
        os.environ.update(env)
        try:
            out[name] = plan_path_one_start(hg, inter)
        finally:
            for k, v in saved.items():
                if v is None:
                    os.environ.pop(k, None)
                else:
                    os.environ[k] = v
    return out


def main() -> dict:
    from eig_kl_tpu_torch.graph.expand import clique_expand
    from eig_kl_tpu_torch.kl.megakernel import fused_refine_mega
    from eig_kl_tpu_torch.models.generator import CircuitGenerator
    from eig_kl_tpu_torch.utils.config import KLConfig, SpectralConfig

    torch.set_num_threads(1)
    hg = CircuitGenerator(1.0, 42).generate()
    g = clique_expand(hg, "kl").to_device("cpu")
    lay = g.plan_layout
    out = {"plan": {"nodes": g.num_nodes, "nnz": g.nnz, "rblock": lay.rblock, "quantum": lay.quantum,
                    "g1": lay.g1, "g2": lay.g2, "tail": type(lay.tail).__name__}}
    t0 = time.perf_counter()
    eig, kl, iters = fused_refine_mega(g, SpectralConfig(solver="power"), KLConfig(gain_eps=1e-6))
    out["fused_refine_mega"] = {
        "iterations": iters, "eigenvalue": eig.eigenvalue, "initial": kl.initial_cut, "best": kl.best_cut,
        "swaps": kl.iterations, "final": kl.final_cut, "verified": kl.verified_cut,
        "side_1": int(eig.sides.sum()), "s": time.perf_counter() - t0,
    }
    out["plan_path_bf16i"] = plan_path_one_start(hg)
    return out


if __name__ == "__main__":
    print(json.dumps(forms() if "--forms" in sys.argv[1:] else main()))
