"""repro_torch.core — the paper's contribution: a compiler that turns a
static operator graph into (subtasks, core mapping, static DMA schedule,
WCET bound) for an interference-free multicore scratchpad machine, plus the
executors that replay the compiled program in torch and on the CUDA
kernels.

Pipeline (paper Fig. 2):
    Graph --Partitioner--> [Subtask] --map_reverse_affinity--> Mapping
          --compute_schedule--> StaticSchedule --wcet.analyze--> WCETReport
          --execute_schedule--> numerics (bit-exact vs reference_forward)

The preferred front door for the whole pipeline is ``repro_torch.compile()``
(`repro_torch.compiler`), which returns a serializable `Deployment`.
"""

from .graph import Graph, OpNode, TensorSpec
from .partition import Partitioner, Subtask, Transfer, PartitionError
from .mapping import Mapping, map_reverse_affinity, map_round_robin
from .schedule import (StaticSchedule, DMASlot, ComputeSlot, ScheduleError,
                       compute_schedule, validate_schedule)
from .taskset import (NetworkSpec, Job, CompiledTaskset, TasksetError,
                      hyperperiod, compile_taskset, schedule_taskset)
from .wcet import (WCETReport, TasksetReport, NetworkVerdict, analyze,
                   analyze_taskset, critical_path, report_from_schedule,
                   subtask_wcet)
from .executor import (reference_forward, execute_schedule, init_params,
                       params_from_reference, ScheduleReplayer, im2col,
                       im2col_reference)
from .compiled import (CompiledProgram, CompileError, clear_program_cache,
                       compile_graph, graph_signature, kernel_batched,
                       lower_program, resolve_device, run_kernels,
                       run_numpy, run_torch, supports_graph, torch_batched)
from .megakernel import megakernel_batched, plan_segments, run_megakernel
from . import cnn, quantize

__all__ = [
    "Graph", "OpNode", "TensorSpec", "Partitioner", "Subtask", "Transfer",
    "PartitionError", "Mapping", "map_reverse_affinity", "map_round_robin",
    "StaticSchedule", "DMASlot", "ComputeSlot", "ScheduleError",
    "compute_schedule", "validate_schedule", "NetworkSpec", "Job",
    "CompiledTaskset", "TasksetError", "hyperperiod", "compile_taskset",
    "schedule_taskset", "WCETReport", "TasksetReport", "NetworkVerdict",
    "analyze", "analyze_taskset", "critical_path", "report_from_schedule",
    "subtask_wcet", "reference_forward", "execute_schedule", "init_params",
    "params_from_reference", "ScheduleReplayer", "im2col",
    "im2col_reference",
    "CompiledProgram", "CompileError", "clear_program_cache",
    "compile_graph", "graph_signature", "kernel_batched", "lower_program",
    "resolve_device", "run_kernels", "run_numpy", "run_torch",
    "supports_graph", "torch_batched",
    "megakernel_batched", "plan_segments", "run_megakernel",
    "cnn", "quantize",
]
