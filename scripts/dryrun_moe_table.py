"""The dry-run's counts of the MoE archs under each dispatch, as markdown.

    PYTHONPATH=src python scripts/dryrun_moe_table.py     # ~6 min

For each MoE arch x (``decode_32k`` AR, ``decode_32k`` at gamma 4,
``prefill_32k``) x mesh (``"1x8"``, ``"4x8"``) it counts rank 0's step
under ``onehot``, ``gmm`` and ``ep`` (``launch/dryrun.count_combo``: the
meta device, ``gmm`` and ``ep`` on the stated uniform routing) and prints
one table, one row an (arch, shape), each cell ``onehot / gmm / ep`` on
``"1x8"`` then, after a ``‖``, on ``"4x8"``: FLOPs a rank, resident and
peak bytes, all-gather bytes, ``ep``'s all-to-all bytes as issued (the
padded slot buffers) beside ``core/perf_model.ep_a2a_bytes``' mean over
the MoE layers, and the roofline's collective term
(``launch/roofline.analyze`` over ``H100``: NVLink at 450 GB/s a way
inside a node, InfiniBand at 50 GB/s across nodes).  Every figure is a
count on the meta device, not a device time.
Imports the port alone.
"""
from repro_torch.configs.base import INPUT_SHAPES
from repro_torch.core.perf_model import ep_a2a_bytes
from repro_torch.launch import roofline
from repro_torch.launch.dryrun import DISPATCHES, MESHES, count_combo
from repro_torch.launch.specs import arch_for_shape

MOE_ARCHS = ("dbrx-132b", "jamba-v0.1-52b", "mixtral-8x7b",
             "qwen2-57b-a14b", "qwen3-moe-30b-a3b")
CASES = (("decode_32k", 0), ("decode_32k", 4), ("prefill_32k", 0))
G = 1e9


def modelled_a2a(arch: str, shape_name: str, gamma: int, dims: dict
                 ) -> float:
    """``ep_a2a_bytes`` of the tokens of one data group over its model
    group, summed over the MoE layers: the mean volume a rank sends."""
    shape = INPUT_SHAPES[shape_name]
    cfg = arch_for_shape(arch, shape, gamma)
    T = shape.seq_len if shape.kind == "prefill" else gamma + 1
    tokens = shape.global_batch * T // dims.get("data", 1)
    moe_layers = sum(cfg.moe_pattern[l % cfg.period]
                     for l in range(cfg.num_layers))
    return moe_layers * ep_a2a_bytes(tokens, cfg.num_experts_per_tok,
                                     cfg.d_model, dims["model"])


def _cell(recs, fn, fmt="{:.2f}") -> str:
    return " / ".join(fmt.format(fn(r)) for r in recs)


def _resident(recs) -> str:
    """One figure where the dispatches hold the same (the placement does
    not depend on the dispatch), else one each."""
    fn = lambda r: r["memory"]["argument_bytes"] / G  # noqa: E731
    if len({r["memory"]["argument_bytes"] for r in recs}) == 1:
        return f"{fn(recs[0]):.2f}"
    return _cell(recs, fn)


def _cells(arch: str, shape: str, gamma: int, mesh: str) -> list:
    """The row's cells on one mesh, each ``onehot / gmm / ep``."""
    recs = [count_combo(arch, shape, multi_node=mesh == "4x8", gamma=gamma,
                        moe_dispatch=d) for d in DISPATCHES]
    coll = [r["collective_bytes_per_device"] for r in recs]
    ana = [roofline.analyze(r) for r in recs]
    model = modelled_a2a(arch, shape, gamma, MESHES[mesh])
    return [_cell(recs, lambda r: r["flops_per_device"] / 1e12),
            _resident(recs),
            _cell(recs, lambda r: r["memory"]["peak_bytes"] / G),
            _cell(coll, lambda c: c["all-gather"] / G, "{:.3f}"),
            f"{coll[2]['all-to-all'] / G:.4f}; {model / G:.4f}",
            _cell(ana, lambda a: a["t_collective_s"] * 1e3)]


def main() -> int:
    print("Each cell onehot / gmm / ep, on 1x8 ‖ 4x8.\n")
    print("| arch · shape | TFLOP a rank | resident GB | peak GB | "
          "all-gather GB | ep all-to-all GB, issued; modelled | "
          "collective term ms |")
    print("|---|---|---|---|---|---|---|")
    for arch in MOE_ARCHS:
        for shape, gamma in CASES:
            per_mesh = [_cells(arch, shape, gamma, mesh)
                        for mesh in ("1x8", "4x8")]
            label = f"{shape} γ {gamma}" if gamma else shape
            cells = [" ‖ ".join(c) for c in zip(*per_mesh)]
            print(f"| {arch} · {label} | " + " | ".join(cells) + " |")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
