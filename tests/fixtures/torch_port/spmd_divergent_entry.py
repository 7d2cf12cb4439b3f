"""Demo stage-3 fixture of the port: a rank-conditional collective, the
deadlock shape graftlint's SPMD stage exists to catch (the torch twin of
tests/fixtures/spmd_divergent_entry.py).

`python3 port_tools/graftlint.py --check --stage spmd tests/fixtures/\
torch_port/spmd_divergent_entry.py` must exit non-zero with BOTH a G010
AST finding (the rank-guarded all-reduce below is visible statically)
and a C003 deadlock finding from the collective audit naming the two
divergent sequences: rank 0 issues the all-reduce, rank 1 never joins
it, and on a live fleet rank 0 waits for it forever.

The GRAFTLINT_SPMD_ENTRIES hook is the external-entry contract of
deeplearning4j_tpu_torch/analysis/collective_audit.py: {name: builder},
builder() -> (fn, args), called under the simulated process group.
"""


def build_divergent():
    import torch
    import torch.distributed as dist

    def fn(x):
        if dist.get_rank() == 0:  # rank-conditional collective
            dist.all_reduce(x)
            return x
        return x * 2.0  # rank 1 never reaches the all-reduce: deadlock

    return fn, (torch.ones(4),)


GRAFTLINT_SPMD_ENTRIES = {"demo/rank_conditional_all_reduce":
                          build_divergent}
