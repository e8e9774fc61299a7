"""Perf-iteration driver (the port of ``repro.launch.hillclimb``): re-runs
the reference's three hillclimb cells under its named configuration
variants through the port's dry run, and records tagged records.

Each variant encodes one hypothesis of the reference's iteration log; the
entries are the reference's, entry for entry. On one device the port's
records differ only where a variant changes the traced program
(``kv_chunk``, ``moe_groups``) or the specs (``rules_override``: the
per-device bytes); ``moe_shard`` is accepted and ignored (ROADMAP C18), and
the collective bytes the hypotheses are about are left out (ROADMAP C26).

    PYTHONPATH=src python -m repro_torch.launch.hillclimb [variant ...]
"""
import sys

from .dryrun import DEFAULT_OUT, run_cell

__all__ = ["VARIANTS", "main"]

# (arch, shape, tag, overrides): the reference's variants. Each comment
# is the reference's hypothesis about its partitioned TPU program.
VARIANTS = {
    # -- phi3-medium-14b x prefill_32k ------------------------------------
    # H1: head_dim tensor parallelism makes q k^T contract over a sharded
    #     axis, so the float32 score tensor is all-reduced every layer;
    #     replicating attention (TP only in mlp / vocab) removes it.
    "phi3_it1": ("phi3-medium-14b", "prefill_32k", "_it1_nohd",
                 dict(rules_override={"head_dim": None})),
    # H2: blockwise attention removes the S^2 scores.
    "phi3_it2": ("phi3-medium-14b", "prefill_32k", "_it2_chunk",
                 dict(rules_override={"head_dim": None}, kv_chunk=2048)),
    # H3: batch over both axes (pure DP for attention-heavy prefill);
    #     kv_chunk retained.
    "phi3_it3": ("phi3-medium-14b", "prefill_32k", "_it3_dp256",
                 dict(rules_override={"head_dim": None,
                                      "batch": ("data", "model"),
                                      "mlp": None, "heads": None,
                                      "kv_heads": None},
                      kv_chunk=2048)),

    # -- kimi-k2-1t-a32b x train_4k ---------------------------------------
    # H1: the int8 moments' last-axis block layout (optim.adamw.Q8, now the
    #     default) inherits the parameter's sharding; this isolates it.
    "kimi_it1": ("kimi-k2-1t-a32b", "train_4k", "_it1_q8layout", dict()),
    # H2: shard-local dispatch groups (= the data axis) keep routing inside
    #     each shard.
    "kimi_it2": ("kimi-k2-1t-a32b", "train_4k", "_it2_groups",
                 dict(moe_groups=16)),
    # H3: the FSDP axis on the expert mlp dim to shrink the per-layer
    #     weight gathers.
    "kimi_it3": ("kimi-k2-1t-a32b", "train_4k", "_it3_mlpshard",
                 dict(moe_groups=16,
                      rules_override={"embed": None, "mlp": "data"})),

    # -- minicpm-2b x train_4k --------------------------------------------
    # H1: no tensor parallelism: batch over both axes (DP-256).
    "minicpm_it1": ("minicpm-2b", "train_4k", "_it1_dp256",
                    dict(rules_override={"batch": ("data", "model"),
                                         "mlp": None, "heads": None,
                                         "kv_heads": None,
                                         "vocab": "model", "embed": "data"})),
    # H2: keep TP, sequence-shard the residual stream (Megatron-SP).
    "minicpm_it2": ("minicpm-2b", "train_4k", "_it2_seqshard",
                    dict(rules_override={"seq": "model"})),

    # H4 (kimi): pin the capacity buffers (group -> data, expert -> model).
    "kimi_it4": ("kimi-k2-1t-a32b", "train_4k", "_it4_moeshard",
                 dict(moe_groups=16, moe_shard=("data", "model"))),
    # H5 (kimi): constrain only the group axis.
    "kimi_it5": ("kimi-k2-1t-a32b", "train_4k", "_it5_groupshard",
                 dict(moe_groups=16, moe_shard=("data", None))),
    # H6 (kimi): constrain only the token-side tensors.
    "kimi_it6": ("kimi-k2-1t-a32b", "train_4k", "_it6_tokonly",
                 dict(moe_groups=16, moe_shard=("data", "tokens-only"))),

    # -- mixtral inherits the kimi dispatch changes ------------------------
    "mixtral_groups": ("mixtral-8x7b", "train_4k", "_it1_groups",
                       dict(moe_groups=16)),
    "mixtral_it2": ("mixtral-8x7b", "train_4k", "_it2_moeshard",
                    dict(moe_groups=16, moe_shard=("data", None))),

    # H4 (phi3): shard attention over the sequence instead of heads.
    "phi3_it4": ("phi3-medium-14b", "prefill_32k", "_it4_seqshard",
                 dict(rules_override={"head_dim": None, "seq": "model"},
                      kv_chunk=2048)),
}


def main(argv=None, out_dir: str = DEFAULT_OUT, traces: dict = None,
         card: tuple = None) -> list:
    """Run the named variants (every one by default); ``traces`` and
    ``card`` as ``dryrun.run_cell`` takes them."""
    picks = (sys.argv[1:] if argv is None else list(argv)) or list(VARIANTS)
    traces = {} if traces is None else traces
    recs = []
    for name in picks:
        arch, shape, tag, ov = VARIANTS[name]
        rec = run_cell(arch, shape, multi_pod=False, out_dir=out_dir,
                       tag=tag, traces=traces, card=card, **ov)
        status = rec["status"]
        extra = ""
        if status == "ok":
            extra = (f" trace {rec['trace_s']}s flops {rec['flops']:.3g}"
                     f" peak {rec['peak_bytes'] / 1e9:.0f} GB args/dev "
                     f"{rec['argument_bytes_per_device']['total'] / 1e9:.2f}"
                     " GB")
        elif status == "fail":
            extra = " " + rec["error"][:200]
        print(f"[{status}] {name}: {arch} x {shape} {tag}{extra}", flush=True)
        recs.append(rec)
    return recs


if __name__ == "__main__":
    main()
