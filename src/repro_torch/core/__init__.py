"""MEP-Opt core on PyTorch: the paper's contribution as a composable module.

Port of ``repro.core``.  Pipeline:  extract (KernelCase) → complete
(build_mep, eq. 1–2) → iterate (optimize, eq. 3–5, AER, PPI) → reintegrate
(integrate.install).
"""
from repro_torch.core.kernelcase import (ArraySpec, KernelCase, Variant,
                                         cases, get_case, register)
from repro_torch.core.datagen import DataBudget, generate
from repro_torch.core.measure import (DeviceLease, MeasureConfig,
                                      TimingLease, get_device_lease,
                                      get_lease, measure_callable,
                                      measure_fn, trimmed_stats)
from repro_torch.core.mep import MEP, MEPConstraints, build_mep, emit_script
from repro_torch.core.profiler import (H100ModelPlatform, H100Platform,
                                       H100TorchPlatform, Platform,
                                       TimingResult,
                                       TorchCPUPlatform, platform_from_name,
                                       register_platform, trimmed_mean)
from repro_torch.core.fe import FEResult, check as fe_check, outputs_match
from repro_torch.core.aer import AER, RepairRecord, WorkerFault
from repro_torch.core.patterns import Pattern, PatternStore
from repro_torch.core.proposer import (DirectProposer, HeuristicProposer,
                                       LLMBatcher, LLMProposer, OfflineError,
                                       PERSONAE, ProposalError, Proposer,
                                       RoundState, chat_completion,
                                       make_proposer, persona_proposers,
                                       proposer_from_spec)
from repro_torch.core.population import (Individual, Population,
                                         PopulationConfig)
from repro_torch.core.evalcache import (EvalCache, EvalRecord, ResultsDB,
                                        canonical_spec, default_namespace,
                                        spec_key, this_host)
from repro_torch.core.optimizer import (CandidateLog, Evaluator, OptConfig,
                                        OptResult, RoundLog, optimize)
from repro_torch.core.chaos import ChaosInjector, Fault, FaultPlan
from repro_torch.core.workers import (CaseJob, Executor, FleetHost,
                                      InProcessExecutor,
                                      LocalClusterExecutor, RemoteExecutor,
                                      SubprocessExecutor, WorkerContext,
                                      backoff_schedule, make_executor,
                                      run_case_job)
from repro_torch.core.replicate import (JournalLink, Replicator,
                                        drain_endpoint)
from repro_torch.core.campaign import Campaign
from repro_torch.core import integrate
