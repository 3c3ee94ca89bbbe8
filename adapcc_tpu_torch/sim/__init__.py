"""The α-β cost model, its calibration artifacts and the collective
simulator (the port of :mod:`adapcc_tpu.sim`): the discrete-event replay
(:mod:`~adapcc_tpu_torch.sim.events`), its vectorized twin
(:mod:`~adapcc_tpu_torch.sim.vector`), the lowerings of strategies, programs
and fault plans (:mod:`~adapcc_tpu_torch.sim.replay`) and the ranking
(:mod:`~adapcc_tpu_torch.sim.rank`).  The congestion replay comes with the
adaptation-loop slice."""

from adapcc_tpu_torch.sim.calibrate import (
    Calibration,
    calibrate_from_matrices,
    load_calibration,
    load_or_default,
)
from adapcc_tpu_torch.sim.cost_model import (
    DCN,
    ICI,
    LinkCoeffs,
    LinkCostModel,
    bandwidth_lower_bound,
    choose_wire_dtype,
    collective_lower_bound,
    fastest_coeffs,
    fit_alpha_beta,
    latency_lower_bound,
    optimality_gap,
)
from adapcc_tpu_torch.sim.events import EventSimulator, SimReport, Transfer, TreeSchedule
from adapcc_tpu_torch.sim.vector import (
    SIM_ENGINE_ENV,
    SIM_ENGINES,
    VECTOR_MIN_WORLD,
    LoweredColumns,
    ProgramColumns,
    clear_lowering_cache,
    clear_program_cache,
    lowered_columns,
    lowering_cache_info,
    program_cache_info,
    program_columns,
    resolve_sim_engine,
    vector_program_run,
    vector_run,
)
from adapcc_tpu_torch.sim.replay import (
    FaultStepRow,
    SimTimeline,
    simulate_broadcast,
    simulate_fault_plan,
    simulate_program,
    simulate_reduce,
    simulate_strategy,
    simulate_xml,
)
from adapcc_tpu_torch.sim.rank import RankedCandidate, predict_degradation, rank_candidates, relay_latency

__all__ = [
    "Calibration",
    "DCN",
    "EventSimulator",
    "FaultStepRow",
    "ICI",
    "LinkCoeffs",
    "LinkCostModel",
    "LoweredColumns",
    "ProgramColumns",
    "RankedCandidate",
    "SIM_ENGINES",
    "SIM_ENGINE_ENV",
    "SimReport",
    "SimTimeline",
    "Transfer",
    "TreeSchedule",
    "VECTOR_MIN_WORLD",
    "bandwidth_lower_bound",
    "calibrate_from_matrices",
    "choose_wire_dtype",
    "clear_lowering_cache",
    "clear_program_cache",
    "collective_lower_bound",
    "fastest_coeffs",
    "fit_alpha_beta",
    "latency_lower_bound",
    "load_calibration",
    "load_or_default",
    "lowered_columns",
    "lowering_cache_info",
    "optimality_gap",
    "predict_degradation",
    "program_cache_info",
    "program_columns",
    "rank_candidates",
    "relay_latency",
    "resolve_sim_engine",
    "simulate_broadcast",
    "simulate_fault_plan",
    "simulate_program",
    "simulate_reduce",
    "simulate_strategy",
    "simulate_xml",
    "vector_program_run",
    "vector_run",
]
