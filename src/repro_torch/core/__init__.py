"""MEP-Opt core on PyTorch: the paper's contribution as a composable module.

Port of ``repro.core``.  Pipeline:  extract (KernelCase) → complete
(build_mep, eq. 1–2) → iterate (optimize, eq. 3–5, AER, PPI) → reintegrate
(integrate.install).
"""
from repro_torch.core.kernelcase import (ArraySpec, KernelCase, Variant,
                                         cases, get_case, register)
from repro_torch.core.datagen import DataBudget, generate
from repro_torch.core.measure import (MeasureConfig, TimingLease, get_lease,
                                      measure_callable, measure_fn,
                                      trimmed_stats)
from repro_torch.core.mep import MEP, MEPConstraints, build_mep, emit_script
from repro_torch.core.profiler import (H100ModelPlatform, H100Platform,
                                       Platform, TimingResult,
                                       TorchCPUPlatform, platform_from_name,
                                       register_platform, trimmed_mean)
from repro_torch.core.fe import FEResult, check as fe_check, outputs_match
from repro_torch.core.aer import AER, RepairRecord
from repro_torch.core.patterns import Pattern, PatternStore
from repro_torch.core.proposer import (DirectProposer, HeuristicProposer,
                                       Proposer, RoundState, make_proposer,
                                       proposer_from_spec)
from repro_torch.core.evalcache import (EvalCache, EvalRecord, ResultsDB,
                                        canonical_spec, default_namespace,
                                        spec_key, this_host)
from repro_torch.core.optimizer import (CandidateLog, Evaluator, OptConfig,
                                        OptResult, RoundLog, optimize)
from repro_torch.core.workers import (CaseJob, Executor, InProcessExecutor,
                                      WorkerContext, run_case_job)
from repro_torch.core.campaign import Campaign
from repro_torch.core import integrate
