"""graftlint for the port — the counterpart of deeplearning4j_tpu/analysis/,
reading deeplearning4j_tpu_torch/ with torch's spellings of the same
hazards. Rule IDs (G001-G034, J001-J004, D001-D003), the `Finding`
contract, inline suppression and the baseline are the JAX package's.

Stages (`core.STAGES`):

1. `ast` (`ast_pass.lint_paths`): the G rules over the package — host
   syncs in hot paths, float64 drift, RNG discipline, recompiles,
   import-time allocations, rendezvous plumbing outside
   distributed/bootstrap.py (ast_rules.py), the serving, input, swap,
   placement, telemetry, sampling, memory and embedding disciplines.
   Pure stdlib; imports neither torch nor jax.
2. `ops` (`op_audit.audit`): runs each public entry point twice — the
   JAX audit's entries, the flash kernels, the fused heads and the LM
   steps of every bench mode — and records the second call's aten ops
   (a TorchDispatchMode) and kernel launches (the wrappers' LAUNCHES):
   J001 host syncs, J002 op count over the frozen bound
   (analysis/op_budget.json, keyed by device), J003 float64, J004 an
   entry missing from the budget. The counterpart of the JAX `jaxpr`
   stage; it imports torch.
3. `spmd`: the rank-divergence AST rules G010-G015, G018 with
   torch.distributed's names (spmd_rules.py), then the collective audit
   (collective_audit.py): each distributed entry's ordered c10d
   signature, recorded by the op audit's recorder as simulated ranks of
   torch's fake process group (`simulated_process_group`), against
   analysis/collective_budget.json — C001 drift, C002 missing, C003 a
   rank-divergent sequence or program, or an unmatched point-to-point
   move (deadlock class).
4. `concurrency`: the host-thread rules G025-G028
   (concurrency_rules.py) and the lock-order audit (lock_audit.py:
   D001 cycles always exit 1, D002 sink reentrancy, D003 drift from
   analysis/lock_order.json). Pure stdlib.
5. `precision`: the dtype-discipline AST rules G031-G034 with torch's
   casts (precision_rules.py), then the precision audit
   (precision_audit.py): each entry's dtype profile from the same
   recorded call as stage 2 (products, additive reductions,
   collectives, converts, int8 tallies, kernel launches) against
   analysis/precision_budget.json, keyed by device — P001 sub-f32
   accumulation, P002 the int8 pairing, P003 convert churn, P004 a
   widened collective, P005 a rank-divergent profile, PB01 drift.

CLI: `python3 port_tools/graftlint.py --check deeplearning4j_tpu_torch`.
Inline suppression: `# graftlint: disable=G00x`; grandfathered findings
live in port_tools/graftlint_baseline.json. Gates:
tests/test_torch_graftlint.py, tests/test_torch_concurrency_lint.py,
tests/test_torch_op_audit.py, tests/test_torch_collective_audit.py and
tests/test_torch_precision_audit.py (`pytest -m "port and lint"`).
"""

from deeplearning4j_tpu_torch.analysis.ast_pass import (iter_py_files,
                                                        lint_paths,
                                                        lint_report,
                                                        lint_source)
from deeplearning4j_tpu_torch.analysis.ast_rules import (NO_COUNTERPART,
                                                         RULE_DOCS)
from deeplearning4j_tpu_torch.analysis.concurrency_rules import (
    guard_map,
    guard_map_for_file,
)
from deeplearning4j_tpu_torch.analysis.core import (STAGES, Finding,
                                                    load_baseline,
                                                    split_baselined,
                                                    write_baseline)

__all__ = [
    "Finding", "NO_COUNTERPART", "RULE_DOCS", "STAGES", "guard_map",
    "guard_map_for_file", "iter_py_files", "lint_paths", "lint_report",
    "lint_source", "load_baseline", "split_baselined", "write_baseline",
]
