"""The collective schedule compiler: one chunk-granular IR, verified,
optimized and run by one lowering.  The port of :mod:`adapcc_tpu.compiler`.

- :mod:`~adapcc_tpu_torch.compiler.ir`: ``ScheduleProgram``/``Step``;
- :mod:`~adapcc_tpu_torch.compiler.builders`: the ring, recursive-doubling,
  binomial-tree, two-level and strategy programs;
- :mod:`~adapcc_tpu_torch.compiler.synthesize`: the bidirectional pipelined
  ring, which only the IR can express;
- :mod:`~adapcc_tpu_torch.compiler.verify`: static certification, rejecting
  with the offending (rank, round, chunk);
- :mod:`~adapcc_tpu_torch.compiler.optimize`: the dce, fuse_codec and
  coalesce passes behind ``ADAPCC_IR_OPT``;
- :mod:`~adapcc_tpu_torch.compiler.lower`: the color plan and its two
  executors, stacked on one device and per rank over a process group,
  behind ``engine.all_reduce(algo="ir")``.
"""

from adapcc_tpu_torch.compiler.builders import (
    program_from_strategy,
    rd_allreduce_program,
    ring_allreduce_program,
    tree_allreduce_program,
    two_level_allreduce_program,
)
from adapcc_tpu_torch.compiler.ir import PROGRAM_COLLECTIVES, STEP_KINDS, ScheduleProgram, Step
from adapcc_tpu_torch.compiler.lower import (
    allreduce_per_shard,
    allreduce_per_shard_two_level,
    dispatch_count,
    execute_program_shard,
    execute_program_stacked,
    execute_program_two_level_shard,
    round_dispatch_counts,
    two_level_color_axes,
)
from adapcc_tpu_torch.compiler.optimize import IR_OPT_ENV, PASS_NAMES, PASSES, optimize_program, resolve_ir_opt
from adapcc_tpu_torch.compiler.synthesize import pipelined_allreduce_program
from adapcc_tpu_torch.compiler.verify import ScheduleVerificationError, normalize_program, verify_program

__all__ = [
    "IR_OPT_ENV",
    "PASSES",
    "PASS_NAMES",
    "PROGRAM_COLLECTIVES",
    "STEP_KINDS",
    "ScheduleProgram",
    "ScheduleVerificationError",
    "Step",
    "allreduce_per_shard",
    "allreduce_per_shard_two_level",
    "dispatch_count",
    "execute_program_shard",
    "execute_program_stacked",
    "execute_program_two_level_shard",
    "normalize_program",
    "optimize_program",
    "pipelined_allreduce_program",
    "program_from_strategy",
    "rd_allreduce_program",
    "resolve_ir_opt",
    "ring_allreduce_program",
    "round_dispatch_counts",
    "tree_allreduce_program",
    "two_level_allreduce_program",
    "two_level_color_axes",
    "verify_program",
]
