"""Parallel-tempered Metropolis-Hastings sampler on torch tensors.

Counterpart of bcm3_tpu/sampler/pt.py (reference: src/sampler/SamplerPT.cpp,
SamplerPTChain.cpp). The whole chain population, E independent ensembles
of an L-temperature ladder, is one stacked tensor on one device, so every
likelihood evaluation of an iteration is one batched call. The JAX
package runs each segment as a jitted `lax.scan`; here a segment is an
eager Python loop of batched tensor operations.

Semantics as in the JAX package and the reference:
- power posterior lprior + T*llh with the T=0 chain sampling directly
  from the prior and the -inf*0 convention (SamplerPTChain.cpp:221-240)
- power-law temperature ladder with T[0] = 0 (SamplerPT.cpp:87-93)
- deterministic/stochastic even-odd and stochastic-random replica
  exchange within each ensemble's ladder (SamplerPT.cpp:28-32, 277-306)
- per-block mixture proposals (Gaussian or t steps) with the MH
  correction and acceptance-EMA scale adaptation
  (bcm3_tpu_torch/sampler/proposal.py)
- a float32 ring-buffer sample history with subsampling (SampleHistory.cpp)
- proposal adaptation at fixed points of the run: the history is
  downsampled on the device, GMMs (best AIC, the MFA fit, one covariance,
  or one covariance per spectral cluster) are fitted per ladder position,
  pooled over ensembles, and the proposals rebuilt (SamplerPT.cpp:231-249,
  SamplerPTChain.cpp AdaptProposal:109-173)
- clustered proposals and blocking: at a boundary one spectral clustering
  is fitted on the pooled fixed-temperature history and shared by every
  chain (the JAX package's batching deviation from the reference's
  per-chain clustering); the blocks of Turek and clustered_autoblock are
  recomputed from that history, so the block structure can change there
- thinned emission, optionally of the fixed-temperature rows only
  (SamplerPT.cpp:321-330)

Randomness comes from one explicit `torch.Generator` on the sampler's
device, a host `np.random.Generator` for the adaptation (seeded as the JAX
package seeds its own, so downsample rows and k-means++ seeds match it
draw for draw) and, for the stochastic swap schemes, a CPU
`torch.Generator` for the per-iteration choice between exchange and
mutate. `_mutate` and `_exchange` take their random numbers as a `draws`
argument, so a test can feed them the JAX package's own draws.

With `checkpoint_file` set, run() saves the whole sampler state after
each adaptation and after each segment between boundaries, and resumes
from that file when it exists (io/checkpoint.py), as the JAX package does
(bcm3_tpu/sampler/pt.py:1379-1391, 1450-1453, 1568-1569). With
`output_proposal_adaptation` each boundary's T=1 mixtures and pooled T=1
history are kept in `adaptation_dumps` for sampler_adaptation.nc. A
`progress` object (io/progress.py) attached by the caller is told each
emitted chunk.

Emission is chunked and overlapped, as the JAX package's
(bcm3_tpu/sampler/pt.py:1475-1560): a segment runs in chunks of
`emit_chunk_size` emissions; each chunk's stacked rows are copied to
pinned host buffers on a copy stream without blocking, and drained
(pooled, stored, handed to the handlers) once the next chunk's work is
queued, so the host's share overlaps the device's. The samples are the
same bit for bit for any chunk size. With `profile_dir` set, run() runs
under torch.profiler and writes a TensorBoard trace there.

With `shard_over_devices` in an initialized torch.distributed group
(parallel/distributed.py) the population is split over the ranks, one
process a device (the JAX package's chain mesh, bcm3_tpu/sampler/pt.py:
1395-1414): rank r keeps the contiguous block of chains that
parallel/mesh.py gives it, evaluates only its own rows, and computes
exactly what the unsharded run computes:
- every rank draws the whole population's random numbers and keeps its
  rows (as the JAX package's global key over a sharded array does);
- an iteration issues no collective when every ladder lies whole on one
  rank; where a rank boundary splits a ladder, the rank keeps the
  covering ladders and fills their other ranks' rows point to point
  before each exchange;
- at a boundary the downsampled and the T=1 history are gathered in the
  unsharded order, every rank fits the same proposals with the same host
  RNG and keeps its rows of them, and a digest of each rank's proposals
  and random streams must agree;
- statistics and counters cover the whole world; run() returns each
  rank's own ensembles ("ensemble_shard") where its ladders are whole,
  else the gathered population; sample handlers and the progress line
  run on the primary rank, and the handlers receive the whole population
  (gathered for them under per-rank emission); the primary writes one
  complete checkpoint, which sharded and unsharded runs resume alike.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import logging
import math
import os
import time
from dataclasses import dataclass, field
from typing import List, Optional, Sequence

import numpy as np
import torch

from bcm3_tpu_torch.likelihoods import Likelihood
from bcm3_tpu_torch.model.prior import Prior
from bcm3_tpu_torch.parallel import collectives, distributed
from bcm3_tpu_torch.parallel.mesh import ChainBlock
from bcm3_tpu_torch.sampler import blocking as blocking_mod
from bcm3_tpu_torch.sampler import proposal as prop_mod
from bcm3_tpu_torch.sampler import spectral
from bcm3_tpu_torch.distributions.univariate import sample_standard_gamma
from bcm3_tpu_torch.sampler.proposal import BlockProposal
from bcm3_tpu_torch.stats.gmm import GMM, fit_gmm_best_aic
from bcm3_tpu_torch.stats.gmm_device import fit_gmm_best_aic_device_multi
from bcm3_tpu_torch.stats.mfa import fit_proposal_mtfa

logger = logging.getLogger("bcm3_tpu_torch.sampler")

_NEG_INF = -math.inf

_SWAP_SCHEMES = ("deterministic_even_odd", "stochastic_even_odd", "stochastic_random")
_STOCHASTIC = ("stochastic_even_odd", "stochastic_random")


@dataclass
class PTConfig:
    """Sampler configuration; defaults match the reference option tables
    (reference: Sampler.cpp:142-149, SamplerPT.cpp:147-172)."""

    num_samples: int = 2500
    use_every_nth: int = 1
    seed: int = 0

    num_chains: int = 6
    blocking_strategy: str = "one_block"
    proposal_type: str = "gaussian_mixture"
    adapt_proposal_samples: int = 2000
    adapt_proposal_times: int = 2
    max_history_size: int = 2000
    adapt_proposal_max_history_samples: int = 2000
    adapt_proposal_max_clustering_samples: int = 1000
    # accepted for config compatibility and without effect, as in the JAX
    # package: the reference flag it sets is never read by a proposal
    # (SamplerPT.cpp:250-255)
    stop_proposal_scaling: int = 6000
    sample_clustering_nn: int = 3
    sample_clustering_nn2: int = 7
    sample_clustering_num_clusters: int = 4
    swapping_scheme: str = "deterministic_even_odd"
    # stochastic schemes: chance that an iteration exchanges, else mutates
    exchange_probability: float = 0.5
    num_exploration_steps: int = 1
    temperature_schedule_power: float = 3.0
    temperature_schedule_max: float = 1.0
    proposal_t_dof: float = 0.0
    initial_position_tries: int = 100
    # independent PT replicas advanced in the same batched computation;
    # each owns a full ladder and exchanges only internally
    num_ensembles: int = 1
    # emit only the fixed-temperature (T=1) row of each ladder
    # (reference: SamplerPT.cpp:321-330)
    emit_fixed_only: bool = False
    # dtype of the emitted copies (None = the sampler dtype)
    emit_dtype: Optional[torch.dtype] = None
    # emitted samples are pulled to the host in chunks of this many
    # emissions, each chunk's copy overlapping the next chunk's device
    # work: None = chunks of ~32 MB, 0 = one pull a segment between
    # adaptation boundaries; the samples are the same for any chunk size
    emit_chunk_size: Optional[int] = None
    # when set, run() runs under torch.profiler (CPU and, on a CUDA device,
    # CUDA activities) and writes a TensorBoard trace into this directory
    profile_dir: str = ""
    device: str = "cuda"
    dtype: torch.dtype = torch.float64
    # GMM adaptation fits: "host" = numpy EM, "device" = the batched EM on
    # the sampler's device (stats/gmm_device.py), "auto" = device for 8 or
    # more variables, host otherwise
    gmm_fit_backend: str = "auto"
    # keep each boundary's spectral-clustering intermediates in
    # SamplerPT.clustering_dumps (reference: SampleHistoryClustering.cpp:40-56)
    output_sample_clustering: bool = False
    # save the sampler state to this file at every boundary and segment
    # end, and resume from it when it exists (io/checkpoint.py)
    checkpoint_file: str = ""
    # keep each boundary's T=1 mixtures and history in
    # SamplerPT.adaptation_dumps (reference: SamplerPTChain.cpp:149-166)
    output_proposal_adaptation: bool = False
    # split the chain population over the ranks of the initialized
    # torch.distributed group, one process a device; the total chain count
    # (num_chains * num_ensembles) must be divisible by the world size.
    # Without a group the run is unsharded.
    shard_over_devices: bool = False
    # kept for compatibility with the JAX package's PTConfig, where it is
    # the chain mesh's device count (None = all); it selects nothing here.
    # One process drives one device, so the launch sets the count: None
    # and every value of at least the world size shard over the whole
    # world, and a value below it is refused
    mesh_devices: Optional[int] = None


def temperature_ladder(
    num_chains: int, power: float = 3.0, t_max: float = 1.0
) -> np.ndarray:
    """Power-law ladder with T[0] = 0 (reference: SamplerPT.cpp:87-93)."""
    temps = np.zeros(num_chains)
    for i in range(1, num_chains - 1):
        temps[i] = t_max * (i / (num_chains - 1)) ** power
    temps[num_chains - 1] = t_max
    return temps


@dataclass
class PTState:
    x: torch.Tensor  # (C, D)
    lprior: torch.Tensor  # (C,)
    llh: torch.Tensor  # (C,)
    att_mut: torch.Tensor  # (C,) int32
    acc_mut: torch.Tensor  # (C,) int32
    att_exc: torch.Tensor  # (C,) int32
    acc_exc: torch.Tensor  # (C,) int32
    # (C, H*D) float32 ring buffer, row h of chain c at columns
    # [h*D, (h+1)*D) (the JAX package's flat layout); updated in place
    history: torch.Tensor
    hist_adds: int = 0  # number of AddSample calls (lockstep)
    swap_parity: int = 0  # 0 -> next swap starts even


@dataclass
class BlockDraws:
    """Random numbers of one block's mutate move, per chain."""

    u_scale: torch.Tensor  # (C,) uniforms for the scale update
    gumbel: Optional[torch.Tensor]  # (C, K) Gumbel noise for the pick; None if clustered
    z: torch.Tensor  # (C, d) standard normals for the step
    u_accept: torch.Tensor  # (C,) uniforms for the MH test
    gamma: Optional[torch.Tensor] = None  # (C,) Gamma(nu/2, 1), t proposals only


@dataclass
class MutateDraws:
    prior: torch.Tensor  # (C, D) prior draw for the T=0 chains
    blocks: List[BlockDraws]


@dataclass
class IterationDraws:
    exchange_u: Optional[torch.Tensor]  # (C,) uniforms; None without exchange
    mutate: List[MutateDraws] = field(default_factory=list)  # per exploration step
    # stochastic schemes: the uniform that picks exchange (below
    # exchange_probability) or mutate for the whole population, and for
    # stochastic_random each ensemble's (E,) pair index
    choice_u: Optional[float] = None
    pair: Optional[torch.Tensor] = None


class _EmissionPull:
    """The copies of emitted chunks to the host. On a CUDA device `start`
    queues a chunk's (x, lprior, llh) rows into pinned host buffers on a
    copy stream, after the compute stream's work so far, without blocking;
    `finish` waits for that copy and returns numpy arrays of their own. Two
    sets of buffers alternate, and a chunk is finished before the one after
    the next starts, so no buffer is written before it was drained. On
    another device the rows are on the host already."""

    def __init__(self, device: torch.device):
        self.device = device
        self.cuda = device.type == "cuda"
        self.stream = torch.cuda.Stream(device) if self.cuda else None
        self.buffers = [None, None]
        self.turn = 0

    def start(self, rows):
        if not self.cuda:
            return rows, None, None
        bufs = self.buffers[self.turn]
        if bufs is None or any(b.shape[0] < r.shape[0] or b.shape[1:] != r.shape[1:]
                               or b.dtype != r.dtype for b, r in zip(bufs, rows)):
            bufs = [torch.empty(r.shape, dtype=r.dtype, pin_memory=True) for r in rows]
            self.buffers[self.turn] = bufs
        self.turn ^= 1
        queued = torch.cuda.Event()
        queued.record(torch.cuda.current_stream(self.device))
        self.stream.wait_event(queued)
        with torch.cuda.stream(self.stream):
            host = [b[: r.shape[0]].copy_(r, non_blocking=True) for b, r in zip(bufs, rows)]
        copied = torch.cuda.Event()
        copied.record(self.stream)
        # the device rows stay referenced until the copy is waited for
        return host, copied, rows

    @staticmethod
    def finish(pending):
        host, copied, _ = pending
        if copied is not None:
            copied.synchronize()
        # numpy has no bfloat16: its rounded values travel as float32; a
        # pinned buffer is copied out, as it is written again later
        return [(t.float() if t.dtype == torch.bfloat16 else
                 t.clone() if copied is not None else t).numpy() for t in host]


class SamplerPT:
    """Parallel-tempered MH sampler over a chain population."""

    def __init__(
        self,
        prior: Prior,
        likelihood: Likelihood,
        config: PTConfig,
        sample_handlers: Optional[Sequence] = None,
    ):
        self.prior = prior
        self.likelihood = likelihood
        self.config = config
        self.sample_handlers = list(sample_handlers or [])
        self.device = torch.device(config.device)
        self.dtype = config.dtype
        self._check_options(config)
        # the legacy alias of reference example configs; the MFA fit feeds
        # the same Gaussian-mixture proposal (bcm3_tpu/sampler/pt.py:276-304)
        self._use_mtfa_fit = config.proposal_type == "gaussian_mixture_fit_in_r"
        self.proposal_type = (
            "gaussian_mixture"
            if config.proposal_type in ("parametric_mixture", "gaussian_mixture_fit_in_r")
            else config.proposal_type
        )

        C = config.num_chains
        E = max(1, config.num_ensembles)
        self.ladder_size = C
        self.num_ensembles = E
        self.num_chains = E * C
        self.num_variables = prior.num_variables
        self.ladder = temperature_ladder(
            C, config.temperature_schedule_power, config.temperature_schedule_max
        )
        self.temperatures = np.tile(self.ladder, E)
        # the chain rows this process holds: the whole population, or under
        # shard_over_devices its rank's block (with the covering ladders)
        self._block = self._partition(config)
        self._rows = self.num_chains if self._block is None else self._block.rows
        # where a rank boundary splits a ladder: the point-to-point plan of
        # the ghost rows that an exchange reads
        self._halo = None
        if self._block is not None and not self._block.whole:
            self._halo = self._block.halo_plan()
        # run() returns this rank's own ensembles where its ladders are whole
        self._emit_shard = None
        if self._block is not None and self._block.whole:
            self._emit_shard = self._block.ensembles
        self._temps = torch.as_tensor(
            self._cover(self.temperatures), dtype=self.dtype, device=self.device
        )
        self._t0_mask = self._temps == 0.0
        self._emit_L = 1 if (config.emit_fixed_only and C > 1) else C
        self.emit_ladder = self.ladder[C - self._emit_L:]

        # History sizing (reference: SamplerPT.cpp:115-128)
        expected = config.adapt_proposal_samples * config.use_every_nth
        if C > 1 and config.swapping_scheme == "deterministic_even_odd":
            expected *= config.num_exploration_steps + 1
        expected = max(expected, 1)
        self.history_subsampling = max(
            1, (expected + config.max_history_size - 1) // config.max_history_size
        )
        self.history_size = max(1, expected // self.history_subsampling)

        # the blockings that need history start unblocked
        self._set_blocks(
            blocking_mod.get_blocks(
                "one_block" if config.blocking_strategy == "one_block" else "no_blocking",
                self.num_variables,
            )
        )
        self.proposals: List[BlockProposal] = self._initial_proposals()
        self.adaptations_done = 0
        self.adaptation_timings: List[dict] = []
        self._use_device_gmm = not self._use_mtfa_fit and (
            config.gmm_fit_backend == "device"
            or (config.gmm_fit_backend == "auto" and self.num_variables >= 8)
        )
        # the spectral clustering shared by every chain, fitted at a
        # boundary (spectral.py); None until then or if the fit failed
        self._assigner: Optional[spectral.ClusterAssigner] = None
        # (clustering iteration, {name: array}) per fit, when
        # output_sample_clustering (reference: SampleHistoryClustering.cpp:40-56)
        self.clustering_dumps: List[tuple] = []
        self.clustering_iteration = 0
        # (iteration, [(block, GMM of the T=1 position), ...], pooled T=1
        # history or None) per boundary, when output_proposal_adaptation;
        # iteration 0 holds the starting proposals (bcm3_tpu/sampler/pt.py:386-392)
        self.adaptation_dumps: List[tuple] = []
        if config.output_proposal_adaptation:
            self.adaptation_dumps.append(
                (0, [(b, self._fallback_gmm(b)) for b in self.blocks], None)
            )
        self.adaptation_iteration = 1
        # a console progress sink (io/progress.py), attached by the CLI
        self.progress = None

        seed = config.seed if config.seed != 0 else int(time.time_ns() % (2**31))
        if config.seed == 0 and self._block is not None:
            seed = collectives.broadcast_object(seed)  # one stream for every rank
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(seed)
        # the adaptation's host stream, seeded as the JAX package seeds its own
        self._host_rng = np.random.default_rng(seed ^ 0x9E3779B9)
        # the stochastic schemes' exchange-or-mutate choice decides one
        # branch for the whole population on the host: drawn on the CPU,
        # so reading it never waits for the card (another seed, so that on
        # a CPU run it is not the main stream's first number)
        self._choice_generator = torch.Generator().manual_seed(seed ^ 0x2545F491)
        self.total_evaluations = 0

    @staticmethod
    def _check_options(cfg: PTConfig):
        if cfg.proposal_type not in (
            "gaussian_mixture",
            "parametric_mixture",
            "gaussian_mixture_adjustedAIC",
            "gaussian_mixture_fit_in_r",
            "global_covariance",
            "clustered_covariance",
        ):
            raise ValueError(f"Unknown proposal type '{cfg.proposal_type}'")
        if cfg.blocking_strategy not in ("one_block", "no_blocking", "Turek", "clustered_autoblock"):
            raise ValueError(f"Unknown blocking strategy '{cfg.blocking_strategy}'")
        if cfg.swapping_scheme not in _SWAP_SCHEMES:
            raise ValueError(f"Unknown swapping scheme '{cfg.swapping_scheme}'")
        if cfg.gmm_fit_backend not in ("auto", "host", "device"):
            raise ValueError(f"Unknown gmm_fit_backend '{cfg.gmm_fit_backend}'")
        if cfg.emit_chunk_size is not None and cfg.emit_chunk_size < 0:
            raise ValueError(f"emit_chunk_size must be None or >= 0, got {cfg.emit_chunk_size}")

    def _partition(self, cfg: PTConfig) -> Optional[ChainBlock]:
        """This rank's block of the population under shard_over_devices in
        an initialized process group (even a group of one), else None: the
        whole population here, as the JAX package runs unsharded on one
        device (bcm3_tpu/sampler/pt.py:1395)."""
        if not cfg.shard_over_devices:
            return None
        if not distributed.initialized():
            logger.info("shard_over_devices: no process group is initialized, running unsharded")
            return None
        world = distributed.world()
        if cfg.mesh_devices is not None and cfg.mesh_devices < world:
            raise ValueError(
                f"mesh_devices={cfg.mesh_devices} is below the world size {world}: one "
                "process drives one device, so the launch sets the device count"
            )
        block = ChainBlock(self.num_chains, self.ladder_size, distributed.rank(), world)
        logger.info(
            "Chain population sharded over %d ranks: rank %d owns chains [%d, %d)",
            world, block.rank, block.c0, block.c1,
        )
        return block

    def _cover(self, t):
        """This process's rows of a tensor or array over the whole population."""
        return t if self._block is None else self._block.cover(t)

    def _own(self, t):
        """This rank's own rows of a tensor over this process's rows."""
        return t if self._block is None else t[self._block.own]

    def _gather(self, t):
        """The whole population's values of a per-chain tensor held on this
        process's rows, in chain order (the JAX package's `_to_host`)."""
        if self._block is None:
            return t
        return collectives.all_gather_rows(self._own(t))

    @property
    def expected_emitted_samples(self) -> int:
        """Rows in the output store: per emitted step, one row per ensemble."""
        return self.config.num_samples * self.num_ensembles

    # ------------------------------------------------------------------
    # Proposal construction

    def _fallback_gmm(self, block: np.ndarray) -> GMM:
        """Single Gaussian with prior mean/variance (reference:
        ProposalGaussianMixture.cpp:212-246)."""
        mean = self.prior.marginal_mean()[block]
        var = self.prior.marginal_variance()[block]
        gmm = GMM.from_params(mean[None, :], np.diag(var)[None, :, :], np.ones(1))
        if gmm is None:
            gmm = GMM.from_params(
                np.zeros((1, len(block))), np.eye(len(block))[None], np.ones(1)
            )
        return gmm

    def _set_blocks(self, blocks: List[np.ndarray]):
        """The block structure and its device index and bound tensors."""
        self.blocks = blocks
        self._block_idx = [torch.as_tensor(b, device=self.device) for b in blocks]
        self._bounds = [
            tuple(
                torch.as_tensor(a[b], dtype=self.dtype, device=self.device)
                for a in (self.prior.lower, self.prior.upper)
            )
            for b in blocks
        ]

    def _initial_proposals(self) -> List[BlockProposal]:
        # before any history a clustered proposal is one prior-variance
        # Gaussian (reference: ProposalClusteredCovariance.cpp:154-183)
        ptype = (
            "gaussian_mixture"
            if self.proposal_type == "clustered_covariance"
            else self.proposal_type
        )
        return [
            prop_mod.build_block_proposal(
                [self._fallback_gmm(block)] * self.ladder_size,
                self._rows,
                len(block),
                self.dtype,
                self.device,
                t_dof=self.config.proposal_t_dof,
                proposal_type=ptype,
            )
            for block in self.blocks
        ]

    # ------------------------------------------------------------------
    # Evaluation

    def _evaluate(self, x):
        """Batched prior + likelihood evaluation, x: (C, D). NaNs become
        -inf (proposal rejection), the reference's soft-fail convention
        (reference: LikelihoodPopPKTrajectory.cpp:400-424)."""
        lprior = self.prior.log_pdf(x)
        llh = self.likelihood.log_prob_batched(x)
        if self.likelihood.learning_rate != 1.0:
            llh = llh * self.likelihood.learning_rate
        lprior = torch.where(torch.isnan(lprior), _NEG_INF, lprior)
        llh = torch.where(torch.isnan(llh), _NEG_INF, llh)
        return lprior.to(self.dtype), llh.to(self.dtype)

    def _evaluate_rows(self, x):
        """`_evaluate` of this rank's own rows of x (this process's rows);
        the ghost rows of a split ladder, another rank's, score -inf and are
        never accepted here."""
        b = self._block
        if b is None or b.whole:
            return self._evaluate(x)
        lprior, llh = self._evaluate(x[b.own])
        front, back = (
            torch.full((n,), _NEG_INF, dtype=self.dtype, device=self.device)
            for n in (b.c0 - b.a0, b.a1 - b.c1)
        )
        return torch.cat([front, lprior, back]), torch.cat([front, llh, back])

    def _lpp(self, lprior, llh):
        """Power posterior with the reference's T=0 convention
        (reference: SamplerPTChain.cpp:231-237)."""
        return torch.where(self._t0_mask, lprior, lprior + self._temps * llh)

    # ------------------------------------------------------------------
    # Random numbers

    def draw(self, proposals: Sequence[BlockProposal]) -> IterationDraws:
        """The random numbers of one iteration, from the sampler's generator.
        Under a stochastic swap scheme the exchange-or-mutate uniform comes
        first, from the CPU choice generator, and only the chosen move's
        numbers are drawn.

        Sharded, a rank draws the whole population's numbers, as every rank
        does, and keeps those of its rows: the draws, and with them the
        run, are the unsharded run's bit for bit (the JAX package draws
        from one global key over a sharded array). The redundant draws cost
        microseconds at bench width; a stream per ensemble would avoid them
        (a later speed item)."""
        g, dt, dev = self.generator, self.dtype, self.device
        C, L, cfg = self.num_chains, self.ladder_size, self.config
        cover = self._cover

        def rand(*shape):
            return cover(torch.rand(shape, generator=g, dtype=dt, device=dev))

        def mutate_draws():
            tiny = torch.finfo(dt).tiny
            blocks = []
            prior = cover(self.prior.sample(g, (C,), dt))
            for block, prop in zip(self.blocks, proposals):
                u_scale = rand(C)
                gumbel = None
                if not prop.clustered:
                    gumbel = -torch.log(
                        -torch.log(torch.clamp(rand(C, prop.max_components), min=tiny))
                    )
                z = cover(torch.randn((C, len(block)), generator=g, dtype=dt, device=dev))
                gamma = None
                if prop.t_dof > 0.0:
                    shape = torch.full((C,), 0.5 * prop.t_dof, dtype=dt, device=dev)
                    gamma = cover(sample_standard_gamma(shape, g))
                blocks.append(BlockDraws(u_scale, gumbel, z, rand(C), gamma))
            return MutateDraws(prior, blocks)

        if L > 1 and cfg.swapping_scheme in _STOCHASTIC:
            choice_u = torch.rand((), generator=self._choice_generator, dtype=torch.float64).item()
            if choice_u < cfg.exchange_probability:
                pair = None
                if cfg.swapping_scheme == "stochastic_random":
                    E = self.num_ensembles
                    pair = torch.randint(0, max(L - 1, 1), (E,), generator=g, device=dev)
                    if self._block is not None:
                        e0, ne = self._block.ensembles
                        pair = pair[e0 : e0 + ne]
                return IterationDraws(rand(C), choice_u=choice_u, pair=pair)
            return IterationDraws(None, [mutate_draws()], choice_u=choice_u)
        exchange_u = rand(C) if L > 1 else None
        steps = cfg.num_exploration_steps if L > 1 else 1
        return IterationDraws(exchange_u, [mutate_draws() for _ in range(steps)])

    # ------------------------------------------------------------------
    # Moves

    def _history_add(self, state: PTState, x, mask=None) -> PTState:
        """Ring-buffer add with subsampling for all T != 0 chains
        (reference: SampleHistory.cpp AddSample)."""
        n = state.hist_adds + 1
        if n % self.history_subsampling == 0:
            ix = ((n // self.history_subsampling) - 1) % self.history_size
            write = ~self._t0_mask if mask is None else (~self._t0_mask & mask)
            D = self.num_variables
            cols = state.history[:, ix * D : (ix + 1) * D]
            cols.copy_(torch.where(write[:, None], x.to(torch.float32), cols))
        return dataclasses.replace(state, hist_adds=n)

    def _mask_per_chain(self, new: BlockProposal, old: BlockProposal) -> BlockProposal:
        """Keep the old per-chain proposal state of the T=0 chains."""
        m = self._t0_mask
        return dataclasses.replace(
            new,
            scales=torch.where(m[:, None], old.scales, new.scales),
            acc_ema=torch.where(m[:, None], old.acc_ema, new.acc_ema),
            selected=torch.where(m, old.selected, new.selected),
        )

    def _mutate(self, state: PTState, proposals, draws: MutateDraws):
        """One mutate move for the whole chain population
        (reference: SamplerPTChain.cpp MutateMove:217-313), over this
        process's rows."""
        L = self.ladder_size
        C = state.x.shape[0]
        E = C // L
        t0 = self._t0_mask
        x, lprior, llh = state.x, state.lprior, state.llh
        att_mut, acc_mut = state.att_mut, state.acc_mut
        new_proposals = []

        for bi, block in enumerate(self.blocks):
            prop = proposals[bi]
            bd = draws.blocks[bi]
            idx = self._block_idx[bi]
            lower, upper = self._bounds[bi]
            d = len(block)

            # 1. adaptive scale update (skipped for T=0 chains)
            prop = self._mask_per_chain(prop_mod.update_scales(prop, bd.u_scale), prop)

            # 2. propose new block positions
            x_block = x[:, idx]
            gamma = None if bd.gamma is None else bd.gamma.reshape(E, L)
            clustered = prop.clustered and self._assigner is not None
            if clustered:
                # component = spectral cluster of the current full position
                # (reference: ProposalClusteredCovariance.cpp:26-35), float64
                # as the JAX package assigns
                cur_cluster = spectral.assign_batch(self._assigner, x.to(torch.float64))
                nb, sel = prop_mod.propose_clustered_ensemble(
                    prop, x_block.reshape(E, L, d), cur_cluster.reshape(E, L),
                    lower, upper, bd.z.reshape(E, L, d), gamma,
                )
            else:
                nb, sel, log_fwd_resp = prop_mod.propose_ensemble(
                    prop,
                    x_block.reshape(E, L, d),
                    lower,
                    upper,
                    bd.gumbel.reshape(E, L, -1),
                    bd.z.reshape(E, L, d),
                    gamma,
                )
            new_block = nb.reshape(C, d)
            x_new = x.clone()
            x_new[:, idx] = new_block
            # T=0 chains: a direct prior draw replaces the whole vector,
            # and only in the first block (reference: SamplerPTChain.cpp:221-240)
            x_new = torch.where(t0[:, None], draws.prior if bi == 0 else x, x_new)
            # Dirichlet residual overwrite (reference: SamplerPTChain.cpp:270-278)
            for blk in self.prior.dirichlet_blocks:
                s, r = blk.start, blk.residual_index
                x_new[:, r] = 1.0 - x_new[:, s:r].sum(dim=1)

            # 3. evaluate
            new_lprior, new_llh = self._evaluate_rows(x_new)
            new_lpp = self._lpp(new_lprior, new_llh)
            cur_lpp = self._lpp(lprior, llh)

            # 4. MH test (reference: SamplerPTChain.cpp TestSample:465-482)
            prop = dataclasses.replace(prop, selected=sel.reshape(C))
            if clustered:
                new_cluster = spectral.assign_batch(self._assigner, x_new.to(torch.float64))
                mh = prop_mod.mh_log_ratio_clustered_ensemble(
                    prop, x_block.reshape(E, L, d), nb,
                    cur_cluster.reshape(E, L), new_cluster.reshape(E, L),
                ).reshape(C)
            else:
                mh = prop_mod.mh_log_ratio_ensemble(
                    prop,
                    x_block.reshape(E, L, d),
                    nb,
                    log_fwd_resp=log_fwd_resp,
                ).reshape(C)
            log_u = torch.log(bd.u_accept)
            accept = (new_lpp > _NEG_INF) & (log_u < (new_lpp - cur_lpp) + mh)
            # T=0: always accept, once
            accept = torch.where(t0, bi == 0, accept)

            x = torch.where(accept[:, None], x_new, x)
            lprior = torch.where(accept, new_lprior, lprior)
            llh = torch.where(accept, new_llh, llh)

            # 5. acceptance bookkeeping
            counted = ~t0 if bi > 0 else torch.ones_like(t0)
            att_mut = att_mut + counted.to(att_mut.dtype)
            acc_mut = acc_mut + (accept & counted).to(acc_mut.dtype)

            prop = self._mask_per_chain(prop_mod.notify_accepted(prop, accept), prop)
            new_proposals.append(prop)

        state = dataclasses.replace(
            state, x=x, lprior=lprior, llh=llh, att_mut=att_mut, acc_mut=acc_mut
        )
        return self._history_add(state, x), new_proposals

    def _exchange(self, state: PTState, u: torch.Tensor, pair=None) -> PTState:
        """Replica exchange as a masked chain-axis permutation (reference:
        SamplerPT.cpp DoExchangeMove:277-306, SamplerPTChain.cpp
        ExchangeMove:328-381). u: (C,) uniforms. Pairs form only within
        each ensemble's own ladder: the even/odd pairs of the current
        parity, or under stochastic_random the one pair (pair[e], pair[e]
        + 1) of each ensemble, pair: (E,). Sharded, over this process's
        rows: where a rank boundary splits a ladder, the rows of its other
        ranks that this rank's pairs read come first, point to point (the
        JAX package's collective-permute); with whole ladders no collective
        runs."""
        if self._halo is not None:
            x, lprior, llh = collectives.exchange_boundary_rows(
                [state.x, state.lprior, state.llh], self._halo
            )
            state = dataclasses.replace(state, x=x, lprior=lprior, llh=llh)
        L, total = self.ladder_size, state.x.shape[0]
        E = total // L
        random_pair = self.config.swapping_scheme == "stochastic_random"
        temps = self._temps
        idx = torch.arange(total, device=self.device)
        local = idx % L
        base = idx - local

        if random_pair:
            # one random adjacent pair per ensemble (the reference picks one
            # pair for its single ensemble, SamplerPT.cpp:300-305)
            is_leader = local == pair.repeat_interleave(L)
        else:
            # previous_swap_even toggling (reference: SamplerPT.cpp:283-291)
            start = 1 if state.swap_parity == 1 else 0
            rel = local - start
            is_leader = (rel >= 0) & (rel % 2 == 0)
            if L % 2 == 1:
                # odd ladder: drop the wrap-around leader (the pair
                # re-forms at the next parity), as the JAX package does
                is_leader = is_leader & (local != L - 1)
        partner = base + (local + 1) % L

        lprior_p = state.lprior[partner]
        llh_p = state.llh[partner]
        # power posteriors after a hypothetical swap
        prop_lpp_self = torch.where(temps == 0.0, lprior_p, temps * llh_p + lprior_p)
        temps_partner = temps[partner]
        prop_lpp_partner = torch.where(
            temps_partner == 0.0, state.lprior, temps_partner * state.llh + state.lprior
        )
        cur_lpp = self._lpp(state.lprior, state.llh)
        log_tp = (prop_lpp_self + prop_lpp_partner) - (cur_lpp + cur_lpp[partner])
        swap_leader = is_leader & (torch.log(u) < log_tp)

        def roll_within(mask):
            return torch.roll(mask.reshape(E, L), 1, dims=1).reshape(total)

        swap_follower = roll_within(swap_leader)
        perm = torch.where(
            swap_leader, partner, torch.where(swap_follower, base + (local - 1) % L, idx)
        )
        x = state.x[perm]
        state = dataclasses.replace(
            state,
            x=x,
            lprior=state.lprior[perm],
            llh=state.llh[perm],
            att_exc=state.att_exc + is_leader.to(state.att_exc.dtype),
            acc_exc=state.acc_exc + swap_leader.to(state.acc_exc.dtype),
            swap_parity=1 - state.swap_parity,
        )
        # both members of every pair record history (T != 0 chains)
        # (reference: SamplerPTChain.cpp:370-376); under stochastic_random
        # only the chosen pairs take part
        if random_pair or L % 2 == 1:
            return self._history_add(state, x, mask=is_leader | roll_within(is_leader))
        return self._history_add(state, x)

    def _iteration(self, state: PTState, proposals, draws: IterationDraws):
        """Deterministic even/odd: exchange, then the exploration steps'
        mutates. Stochastic schemes: exchange or one mutate, as the choice
        uniform says. A one-chain ladder only mutates."""
        cfg = self.config
        if self.ladder_size == 1:
            return self._mutate(state, proposals, draws.mutate[0])
        if cfg.swapping_scheme in _STOCHASTIC:
            if draws.choice_u < cfg.exchange_probability:
                return self._exchange(state, draws.exchange_u, draws.pair), proposals
            return self._mutate(state, proposals, draws.mutate[0])
        state = self._exchange(state, draws.exchange_u)
        for ei in range(cfg.num_exploration_steps):
            state, proposals = self._mutate(state, proposals, draws.mutate[ei])
        return state, proposals

    def _run_segment(self, state: PTState, proposals, n_emit: int):
        """n_emit emitted steps of use_every_nth iterations each. Returns the
        new state and proposals and the emitted (x, lprior, llh) stacked on
        the sampler's device in the emission dtype, (n_emit, E * L_emit,
        ...); nothing is read back from the device."""
        L, Le = self.ladder_size, self._emit_L
        xs, lps, lls = [], [], []
        for _ in range(n_emit):
            for _ in range(self.config.use_every_nth):
                state, proposals = self._iteration(state, proposals, self.draw(proposals))
            x, lp, ll = self._emitted(state)
            if Le != L:
                # fixed-temperature rows only (reference: SamplerPT.cpp:321-330)
                x = x.reshape(-1, L, x.shape[-1])[:, L - 1]
                lp = lp.reshape(-1, L)[:, L - 1]
                ll = ll.reshape(-1, L)[:, L - 1]
            xs.append(x)
            lps.append(lp)
            lls.append(ll)
        edt = self.config.emit_dtype or self.dtype
        return state, proposals, tuple(torch.stack(p).to(edt) for p in (xs, lps, lls))

    def _emitted(self, state: PTState):
        """The (x, lprior, llh) rows that run() emits: this process's rows
        (all of them, or a rank's whole ladders), or where a rank boundary
        splits a ladder the whole population's, gathered in one call (as
        the JAX package gathers then, bcm3_tpu/sampler/pt.py:1512-1515)."""
        if self._halo is None:
            return state.x, state.lprior, state.llh
        D = self.num_variables
        rows = torch.cat(
            [self._own(state.x), self._own(state.lprior)[:, None], self._own(state.llh)[:, None]],
            dim=1,
        )
        full = collectives.all_gather_rows(rows)
        return full[:, :D], full[:, D], full[:, D + 1]

    # ------------------------------------------------------------------
    # Host orchestration

    def _find_starting_position(self):
        """Prior draws until every chain has a finite power posterior
        (reference: SamplerPTChain.cpp FindStartingPosition:188-215).
        Sharded, every rank draws the whole population and evaluates its
        own rows, and the search ends when every rank's rows are found."""
        C, rows = self.num_chains, self._rows
        temps = self._cover(self.temperatures)
        x = np.zeros((rows, self.num_variables))
        lprior = np.full(rows, _NEG_INF)
        llh = np.full(rows, _NEG_INF)
        found = np.zeros(rows, dtype=bool)
        done = False
        for _ in range(self.config.initial_position_tries):
            draw = self._cover(self.prior.sample(self.generator, (C,), self.dtype))
            dl, dllh = self._evaluate_rows(draw)
            draw, dl, dllh = (t.cpu().numpy() for t in (draw, dl, dllh))
            with np.errstate(invalid="ignore"):
                # power posterior with the T=0 convention (_lpp)
                lpp = np.where(temps == 0.0, dl, dl + temps * dllh)
            take = np.isfinite(lpp) & ~found
            x[take] = draw[take]
            lprior[take] = dl[take]
            llh[take] = dllh[take]
            found |= np.isfinite(lpp)
            done = bool(self._own(found).all())
            if self._block is not None:
                missing = torch.tensor([0 if done else 1], device=self.device)
                done = int(collectives.all_reduce_sum(missing)) == 0
            if done:
                break
        if not done:
            raise RuntimeError(
                "Could not find starting position with finite power posterior "
                f"after {self.config.initial_position_tries} tries"
            )

        def dev(a):
            return torch.as_tensor(a, dtype=self.dtype, device=self.device)

        return dev(x), dev(lprior), dev(llh)

    def _init_state(self) -> PTState:
        x, lprior, llh = self._find_starting_position()
        C = self._rows

        def zeros():
            return torch.zeros(C, dtype=torch.int32, device=self.device)

        return PTState(
            x=x,
            lprior=lprior,
            llh=llh,
            att_mut=zeros(),
            acc_mut=zeros(),
            att_exc=zeros(),
            acc_exc=zeros(),
            history=torch.zeros(
                (C, self.history_size * self.num_variables),
                dtype=torch.float32,
                device=self.device,
            ),
        )

    # ------------------------------------------------------------------
    # Adaptation boundary

    def _history_count(self, state: PTState) -> int:
        return min(self.history_size, state.hist_adds // self.history_subsampling)

    def _history_matrices(self, state: PTState):
        """The whole history on the host, (C, count, D) float64, and count:
        the host path that `_ladder_downsampled_history` replaces, kept as
        its reference."""
        hist = state.history.cpu().numpy().astype(np.float64)
        hist = hist.reshape(-1, self.history_size, self.num_variables)
        count = self._history_count(state)
        return hist[:, :count, :], count

    def _downsample_indices(self, n: int) -> np.ndarray:
        """Row indices of the subsample-then-random-discard downsample
        (reference: Proposal.cpp:86-129), from the host RNG stream."""
        max_n = self.config.adapt_proposal_max_history_samples
        if n <= max_n:
            return np.arange(n)
        stride = n // max_n
        ix = list(np.arange(0, n // stride) * stride if stride > 1 else np.arange(n))
        while len(ix) > max_n:
            ix.pop(int(self._host_rng.integers(0, len(ix))))
        return np.asarray(ix)

    def _downsample_history(self, h: np.ndarray) -> np.ndarray:
        """Subsample-then-random-discard of host rows (reference:
        Proposal.cpp:86-129)."""
        return h[self._downsample_indices(len(h))]

    def _ladder_downsampled_history(self, state: PTState, count: int):
        """Per ladder position, the downsampled history pooled over
        ensembles, as (n, D) float64 on the host. The rows are gathered on
        the device from the flat (C, H*D) buffer, so only the downsampled
        rows cross to the host (the whole history is gigabytes at the
        bench config). Indices come from the host RNG in position order,
        T=0 included, so the stream is the host path's and the JAX
        package's.

        Sharded, every rank draws the same indices and takes the rows it
        owns; one all-gather puts them in the unsharded order (the rows of
        a position ascend by chain, so by rank): the counterpart of the JAX
        package's `process_allgather`."""
        if self._block is not None:
            return self._gathered_downsampled_history(state, count)
        L, D = self.ladder_size, self.num_variables
        n = self.num_ensembles * count
        cols_d = torch.arange(D, device=self.device)
        out = []
        for i in range(L):
            ix = self._downsample_indices(n)
            e, t = ix // max(count, 1), ix % max(count, 1)
            rows = torch.as_tensor(i + e * L, device=self.device)
            cols = torch.as_tensor(t, device=self.device)[:, None] * D + cols_d
            out.append(state.history[rows[:, None], cols].cpu().numpy().astype(np.float64))
        return out

    def _gathered_downsampled_history(self, state: PTState, count: int):
        """`_ladder_downsampled_history` of a sharded run."""
        L, D, b = self.ladder_size, self.num_variables, self._block
        n = self.num_ensembles * count
        cols_d = torch.arange(D, device=self.device)
        bounds = distributed.global_chain_mesh(self.num_chains)
        sizes, mine = [], []  # sizes[i][r]: rows of position i that rank r owns
        for i in range(L):
            ix = self._downsample_indices(n)
            e, t = ix // max(count, 1), ix % max(count, 1)
            chain = i + e * L
            sizes.append([int(np.count_nonzero((chain >= p0) & (chain < p1))) for p0, p1 in bounds])
            own = (chain >= b.c0) & (chain < b.c1)
            rows = torch.as_tensor(chain[own] - b.a0, device=self.device)
            cols = torch.as_tensor(t[own], device=self.device)[:, None] * D + cols_d
            mine.append(state.history[rows[:, None], cols])
        counts = [sum(s[r] for s in sizes) for r in range(b.world)]
        full = collectives.all_gather_rows(torch.cat(mine), counts).cpu()
        # rank-major, each rank's rows position by position
        out, off = [[] for _ in range(L)], 0
        for r in range(b.world):
            for i in range(L):
                out[i].append(full[off : off + sizes[i][r]])
                off += sizes[i][r]
        return [torch.cat(parts).numpy().astype(np.float64) for parts in out]

    def _pooled_fixed_history(self, state: PTState, count: int) -> torch.Tensor:
        """The fixed-temperature (T=1) history of every ensemble, pooled, as
        (E * count, D) float32 on the device, ensemble-major (the JAX
        package's hist[L-1::L] rows): the one ladder position that the
        clustering and the blockings read, without the rest of the buffer.
        Sharded, each rank's T=1 rows gathered in rank order."""
        L, D, b = self.ladder_size, self.num_variables, self._block
        if b is None:
            return state.history[L - 1 :: L, : count * D].reshape(-1, D)
        first = b.c0 + (L - 1 - b.c0 % L) % L  # this rank's first T=1 chain
        mine = state.history[first - b.a0 : b.c1 - b.a0 : L, : count * D]
        counts = [len(range(p0 + (L - 1 - p0 % L) % L, p1, L))
                  for p0, p1 in distributed.global_chain_mesh(self.num_chains)]
        return collectives.all_gather_rows(mine, counts).reshape(-1, D)

    def _check_replicas_agree(self):
        """After a sharded boundary every rank must hold the same proposal
        mixtures, blocks, clustering and random streams (each fitted the
        same gathered history with the same host RNG): their digests are
        gathered, and a mismatch raises rather than let the ranks sample
        different chains."""
        h = hashlib.sha256()
        for p in self.proposals:
            for f in ("means", "chols", "inv_chols", "log_weights", "log_c"):
                h.update(getattr(p, f).detach().cpu().numpy().tobytes())
        for blk in self.blocks:
            h.update(np.asarray(blk, dtype=np.int64).tobytes())
        if self._assigner is not None:
            for f in spectral.ARRAY_FIELDS:
                h.update(getattr(self._assigner, f).detach().cpu().numpy().tobytes())
        h.update(json.dumps(self._host_rng.bit_generator.state, sort_keys=True).encode())
        for gen in (self.generator, self._choice_generator):
            h.update(gen.get_state().numpy().tobytes())
        mine = torch.frombuffer(bytearray(h.digest()), dtype=torch.uint8).to(self.device)
        every = collectives.all_gather_rows(mine[None])
        if not bool((every == mine).all()):
            raise RuntimeError(
                "the ranks of a sharded run hold different proposals or random streams "
                "after an adaptation boundary"
            )

    def _adapt_proposals(self, state: PTState):
        """Host-side proposal adaptation (reference: SamplerPTChain.cpp
        AdaptProposal:109-173), in the JAX package's order
        (bcm3_tpu/sampler/pt.py:1074-1283), host RNG draws included:

        1. where clustering or a history blocking needs it, the pooled T=1
           history crosses to the host; the spectral clustering is fitted
           on it and labels it (on the device), and Turek /
           clustered_autoblock re-block the variables from it;
        2. the downsampled history of every ladder position is gathered on
           the device (and labelled, for clustered proposals);
        3. per block and ladder position (pooled over ensembles): a
           best-AIC GMM (host or batched device EM), the MFA fit, one
           covariance, or one covariance per cluster; the proposals are
           rebuilt with fresh scales and the history reset.

        A failed clustering degrades clustered proposals to one covariance.
        Returns the new state and the record [(block, GMM of the T=1
        position), ...]; appends the boundary's breakdown in seconds
        (T=1 pull, spectral fit, labelling, blocking, gather, fits, build)
        and its counts to self.adaptation_timings."""
        cfg = self.config
        L = self.ladder_size
        count = self._history_count(state)
        logger.info("Proposal adaptation with %d history samples per chain", count)
        timing = {f"{part}_seconds": 0.0 for part in (
            "t1_pull", "spectral_fit", "labelling", "blocking", "gather", "fit", "build")}
        timing["fit_stats"] = {}
        needs_clustering = (
            self.proposal_type == "clustered_covariance"
            or cfg.blocking_strategy == "clustered_autoblock"
        )
        history_blocking = cfg.blocking_strategy in ("Turek", "clustered_autoblock")

        t = time.perf_counter()
        pooled_dev = pooled = None
        if (needs_clustering or history_blocking) and count > 2:
            pooled_dev = self._pooled_fixed_history(state, count)
            pooled = pooled_dev.cpu().numpy().astype(np.float64)
        timing["t1_pull_seconds"] = time.perf_counter() - t

        cluster_labels = None
        if needs_clustering and count > 2:
            t = time.perf_counter()
            dump = {} if cfg.output_sample_clustering else None
            self._assigner = spectral.fit_spectral_clustering(
                pooled,
                cfg.sample_clustering_nn,
                cfg.sample_clustering_nn2,
                cfg.sample_clustering_num_clusters,
                cfg.adapt_proposal_max_clustering_samples,
                self._host_rng,
                device=self.device,
                dump_sink=dump,
            )
            t_fit = time.perf_counter()
            timing["spectral_fit_seconds"] = t_fit - t
            if self._assigner is None:
                logger.warning(
                    "Spectral clustering failed; falling back to unclustered "
                    "proposals for this segment"
                )
            else:
                cluster_labels = spectral.assign_history(self._assigner, pooled_dev).cpu().numpy()
                timing["labelling_seconds"] = time.perf_counter() - t_fit
                if dump is not None:
                    # the labels of the whole pooled history (reference:
                    # all_assignment via AssignAllHistorySamples, :213)
                    dump["all_assignment"] = cluster_labels.astype(np.int32)
                    self.clustering_dumps.append((self.clustering_iteration, dump))
                sizes = np.bincount(cluster_labels, minlength=self._assigner.num_clusters)
                timing["cluster_sizes"] = sizes.tolist()
                logger.info(
                    "Spectral clustering: %d clusters over %d samples (cluster sizes %s)",
                    self._assigner.num_clusters, len(pooled), sizes.tolist(),
                )
            self.clustering_iteration += 1

        # one block structure from the pooled T=1 history for every chain
        # (the JAX package's deviation from the reference's per-chain blocks)
        if history_blocking:
            t = time.perf_counter()
            self._set_blocks(
                blocking_mod.get_blocks(
                    cfg.blocking_strategy,
                    self.num_variables,
                    pooled,
                    cluster_assignment=cluster_labels,
                )
            )
            timing["blocking_seconds"] = time.perf_counter() - t
        timing["block_sizes"] = [len(b) for b in self.blocks]

        clustered_active = (
            self.proposal_type == "clustered_covariance" and self._assigner is not None
        )
        t = time.perf_counter()
        ladder_h = self._ladder_downsampled_history(state, count)
        timing["gather_seconds"] = time.perf_counter() - t
        ladder_labels = [None] * L
        if clustered_active:
            t = time.perf_counter()
            ladder_labels = [
                spectral.assign_history(
                    self._assigner, torch.as_tensor(h, device=self.device)
                ).cpu().numpy()
                for h in ladder_h
            ]
            timing["labelling_seconds"] += time.perf_counter() - t

        select_adjusted = self.proposal_type == "gaussian_mixture_adjustedAIC"
        gmm_path = not clustered_active and self.proposal_type not in (
            "global_covariance",
            "clustered_covariance",
        )
        if clustered_active:
            build_ptype = "clustered_covariance"
        elif self.proposal_type == "clustered_covariance":
            build_ptype = "global_covariance"  # degraded: the clustering failed
        else:
            build_ptype = self.proposal_type
        host_fit = fit_proposal_mtfa if self._use_mtfa_fit else fit_gmm_best_aic
        new_proposals, record = [], []
        for block in self.blocks:
            t = time.perf_counter()
            # device backend: every ladder position's (k, retry) fits as
            # one batch per component count (stats/gmm_device.py)
            prefit = {}
            if gmm_path and self._use_device_gmm:
                eligible = [
                    i for i in range(L) if self.ladder[i] != 0.0 and len(ladder_h[i]) >= 2
                ]
                if eligible:
                    fitted = fit_gmm_best_aic_device_multi(
                        [ladder_h[i][:, block] for i in eligible],
                        self._host_rng,
                        select_with_adjusted_aic=select_adjusted,
                        log=logger.debug,
                        device=self.device,
                        stats=timing["fit_stats"],
                    )
                    prefit = dict(zip(eligible, fitted))
            ladder_gmms = []
            for i in range(L):
                h = ladder_h[i][:, block]
                if self.ladder[i] == 0.0:
                    gmm = self._fallback_gmm(block)
                    if clustered_active:
                        gmm = self._pad_gmm_components(gmm, self._assigner.num_clusters)
                elif clustered_active:
                    gmm = self._fit_clustered_covariance(h, ladder_labels[i], block)
                elif not gmm_path:
                    gmm = self._fit_global_covariance(h, block)
                else:
                    gmm = prefit.get(i)
                    if not self._use_device_gmm and len(h) >= 2:
                        gmm = host_fit(
                            h, self._host_rng, select_with_adjusted_aic=select_adjusted,
                            log=logger.debug,
                        )
                    if gmm is None:
                        gmm = self._fallback_gmm(block)
                ladder_gmms.append(gmm)
            record.append((block, ladder_gmms[-1]))
            t_built = time.perf_counter()
            timing["fit_seconds"] += t_built - t
            # every ensemble shares the pooled fit: the mixture arrays are
            # stored once per ladder position
            new_proposals.append(
                prop_mod.build_block_proposal(
                    ladder_gmms,
                    self._rows,
                    len(block),
                    self.dtype,
                    self.device,
                    t_dof=cfg.proposal_t_dof,
                    proposal_type=build_ptype,
                )
            )
            timing["build_seconds"] += time.perf_counter() - t_built
            if len(record) == 1:
                timing["components"] = [g.num_components for g in ladder_gmms]
        self.proposals = new_proposals
        self.adaptation_timings.append(timing)
        if cfg.output_proposal_adaptation:
            if pooled is None:
                pooled = self._pooled_fixed_history(state, count).cpu().numpy().astype(np.float64)
            self.adaptation_dumps.append((self.adaptation_iteration, record, pooled))
        self.adaptation_iteration += 1
        # reset history (reference: SamplerPTChain.cpp:170-171)
        return dataclasses.replace(state, hist_adds=0), record

    def _fit_global_covariance(self, h: np.ndarray, block: np.ndarray) -> GMM:
        """Empirical covariance proposal (reference:
        ProposalGlobalCovariance.cpp InitializeImpl:64-105)."""
        d = len(block)
        prior_var = self.prior.marginal_variance()[block]
        if len(h) < 2:
            cov = np.diag(prior_var)
            mean = self.prior.marginal_mean()[block]
        else:
            cov = np.cov(h, rowvar=False, ddof=1).reshape(d, d)
            diag = np.maximum(np.diag(cov), 1e-6 * prior_var)
            cov[np.diag_indices(d)] = diag
            mean = h.mean(axis=0)
        gmm = GMM.from_params(mean[None], cov[None], np.ones(1))
        if gmm is None:
            cov = cov + np.eye(d) * (1e-8 + np.abs(np.diag(cov)).max() * 1e-6)
            gmm = GMM.from_params(mean[None], cov[None], np.ones(1))
        if gmm is None:
            gmm = self._fallback_gmm(block)
        return gmm

    @staticmethod
    def _pad_gmm_components(gmm: GMM, k: int) -> GMM:
        """Replicate a GMM's components to k, equal weights, so that the
        component index can be the cluster index."""
        reps = int(np.ceil(k / gmm.num_components))
        means = np.tile(gmm.means, (reps, 1))[:k]
        covs = np.tile(gmm.covariances, (reps, 1, 1))[:k]
        out = GMM.from_params(means, covs, np.full(k, 1.0 / k))
        return out if out is not None else gmm

    def _fit_clustered_covariance(
        self, h: np.ndarray, labels: np.ndarray, block: np.ndarray
    ) -> GMM:
        """One covariance per spectral cluster, equal weights (reference:
        ProposalClusteredCovariance.cpp InitializeImpl:185-207). Component
        index = cluster index; a cluster with too few samples takes the
        covariance of the whole history."""
        k = self._assigner.num_clusters
        d = len(block)
        fallback = self._fit_global_covariance(h, block)
        means = np.tile(fallback.means[0], (k, 1))
        covs = np.tile(fallback.covariances[0], (k, 1, 1))
        for ci in range(k):
            sel = h[labels == ci]
            if len(sel) >= max(2, d):
                c = np.cov(sel, rowvar=False, ddof=1).reshape(d, d)
                c[np.diag_indices(d)] += 1e-8
                if np.all(np.isfinite(c)):
                    means[ci] = sel.mean(axis=0)
                    covs[ci] = c
        gmm = GMM.from_params(means, covs, np.full(k, 1.0 / k))
        if gmm is None:
            for ci in range(k):
                covs[ci][np.diag_indices(d)] += 1e-6 * np.abs(np.diag(covs[ci])).max() + 1e-10
            gmm = GMM.from_params(means, covs, np.full(k, 1.0 / k))
        if gmm is None:
            gmm = self._pad_gmm_components(self._fallback_gmm(block), k)
        return gmm

    # ------------------------------------------------------------------
    # Main loop

    def run(self):
        """Run the sampler (reference: SamplerPT.cpp RunImpl:185-260); with
        `profile_dir`, under torch.profiler (bcm3_tpu/sampler/pt.py:1349-1365).

        Each run starts from a fresh start-position search and from
        self.proposals, which only an adaptation changes: a later run()
        starts from the adapted proposals with fresh scales, and adapts
        again only if adaptations remain (self.adaptations_done counts
        them across runs), as in the JAX package. With `checkpoint_file`
        set and present, the run instead continues from the checkpoint's
        state, proposals, random streams and counters; a due adaptation
        then runs at the top of the loop, so that the resumed run adapts
        exactly like an uninterrupted one, and a checkpoint of a finished
        run gives an empty tail.

        Returns a dict with samples (S*E, L_emit, D), log_prior and
        log_likelihood (S*E, L_emit), temperatures, acceptance counts and
        the adaptation records, seconds and boundary count of this run
        (adaptation_breakdown: per boundary, the seconds of its parts, the
        EM's counts, the block sizes and the cluster sizes, see
        `_adapt_proposals`);
        elapsed_seconds is the whole call's wall, sampling_seconds that of
        the iterations alone (without the start-position search and the
        adaptation boundaries). Sharded, "ensemble_shard" is (first
        ensemble, count) of a rank whose ladders are whole, whose samples
        are then its own ensembles' only (merge them with
        io/output.py's merge_sharded_results), else None; the acceptance
        counts and evaluations cover every rank, and the primary's sample
        handlers receive every rank's rows."""
        if not self.config.profile_dir:
            return self._run()
        from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

        activities = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            activities.append(ProfilerActivity.CUDA)
        with profile(activities=activities,
                     on_trace_ready=tensorboard_trace_handler(self.config.profile_dir)):
            return self._run()

    def _run(self):
        cfg = self.config
        t_start = time.perf_counter()
        self.adaptation_seconds = 0.0
        self.adaptation_boundaries = 0
        self.adaptation_timings = []
        adaptation_records = []
        # the sample handlers and the progress line are the primary rank's;
        # the handlers receive the whole population: where each rank
        # returns its own ensembles, the rows are gathered for them, chunk
        # by chunk, if the primary has any (a broadcast tells every rank)
        primary = self._block is None or distributed.is_primary()
        handlers = self.sample_handlers if primary else []
        gather_for_handlers = self._emit_shard is not None and collectives.broadcast_object(
            bool(handlers))
        progress = self.progress if primary else None
        if progress is not None:
            progress.start()
        progress_rows = 0
        emit_ensembles = self.num_ensembles if self._emit_shard is None else self._emit_shard[1]

        emitted = 0
        if cfg.checkpoint_file and os.path.exists(cfg.checkpoint_file):
            emitted, state, proposals = self._restore_checkpoint(cfg.checkpoint_file)
            logger.info(
                "Resumed from checkpoint %s at %d emitted samples", cfg.checkpoint_file, emitted
            )
            for handler in handlers:
                if hasattr(handler, "set_position"):
                    handler.set_position(emitted * self.num_ensembles)
        else:
            state = self._init_state()
            proposals = list(self.proposals)

        chunk = cfg.emit_chunk_size
        if chunk is None:  # ~32 MB a pull
            itemsize = torch.finfo(cfg.emit_dtype or self.dtype).bits // 8
            bytes_per_emit = (self.num_ensembles * self._emit_L * (self.num_variables + 2)
                              * itemsize)
            chunk = max(1, (32 << 20) // bytes_per_emit)
        pull = _EmissionPull(self.device)

        all_x, all_lprior, all_llh = [], [], []

        def drain(pending):
            """Wait for a chunk's copy, then pool, store and hand it on."""
            nonlocal progress_rows
            rows = pull.finish(pending)
            xs, lps, lls = (self._pool_ensembles(a) for a in rows)
            all_x.append(xs)
            all_lprior.append(lps)
            all_llh.append(lls)
            whole = (xs, lps, lls)
            if gather_for_handlers:
                whole = [self._pool_ensembles(self._gather_emitted(a)) for a in rows]
            for handler in handlers:
                handler.receive_samples(*whole, self.emit_ladder)
            if progress is not None:
                # running MAP over the fixed-temperature chains
                # (reference: SamplerPT.cpp:223-226)
                lpost = lps[:, -1].astype(np.float64) + lls[:, -1]
                if lpost.size:
                    progress.notify_max_lposterior(np.max(lpost))
                progress_rows += xs.shape[0]
                progress.update(progress_rows / max(emit_ensembles * cfg.num_samples, 1))

        adapting = cfg.adapt_proposal_samples > 0
        # each segment ends with a drained copy to the host, so its device
        # work is done in here
        t_sampling = time.perf_counter()
        with torch.profiler.record_function("SamplerPT.sampling"):
            while emitted < cfg.num_samples:
                # adaptations due at this point (SamplerPT.cpp:231-249)
                pending = (
                    min(emitted // cfg.adapt_proposal_samples, cfg.adapt_proposal_times)
                    if adapting
                    else 0
                )
                while self.adaptations_done < pending:
                    self._log_statistics(state)
                    logger.info("Updating proposal...")
                    t_adapt = time.perf_counter()
                    with torch.profiler.record_function("SamplerPT.adaptation"):
                        state, record = self._adapt_proposals(state)
                        if self._block is not None:
                            self._check_replicas_agree()
                    adaptation_records.append(record)
                    proposals = list(self.proposals)
                    self.adaptation_seconds += time.perf_counter() - t_adapt
                    self.adaptation_boundaries += 1
                    self.adaptations_done += 1
                    if cfg.checkpoint_file:
                        self._save_checkpoint(cfg.checkpoint_file, state, proposals, emitted)
                if adapting and self.adaptations_done < cfg.adapt_proposal_times:
                    aps = cfg.adapt_proposal_samples
                    stop = min(cfg.num_samples, (emitted // aps + 1) * aps)
                else:
                    stop = cfg.num_samples
                # chunk k is drained once chunk k + 1's work is queued
                size = chunk or stop - emitted
                pending = None
                while emitted < stop:
                    m = min(size, stop - emitted)
                    state, proposals, rows = self._run_segment(state, proposals, m)
                    started = pull.start(rows)
                    if pending is not None:
                        drain(pending)
                    pending = started
                    emitted += m
                drain(pending)
                if cfg.checkpoint_file:
                    self._save_checkpoint(cfg.checkpoint_file, state, proposals, emitted)
        self.state = state
        if progress is not None:
            progress.finish()

        sampling = time.perf_counter() - t_sampling - self.adaptation_seconds
        elapsed = time.perf_counter() - t_start
        # att_mut is int32 per chain; the population total needs int64
        evaluations = self._own(state.att_mut).sum(dtype=torch.int64)
        if self._block is not None:
            evaluations = collectives.all_reduce_sum(evaluations)
        self.total_evaluations = int(evaluations)
        evals_per_sec = self.total_evaluations / max(elapsed, 1e-9)
        logger.info(
            "Sampling finished: %d evaluations in %.2fs (%.1f evals/s)",
            self.total_evaluations,
            elapsed,
            evals_per_sec,
        )
        self._log_statistics(state)

        def host(t):
            return self._gather(t).cpu().numpy()

        if not all_x:  # resumed from a checkpoint of a finished run
            L, D = self._emit_L, self.num_variables
            all_x, all_lprior, all_llh = [np.zeros((0, L, D))], [np.zeros((0, L))], [np.zeros((0, L))]
        return {
            "samples": np.concatenate(all_x, axis=0),
            "log_prior": np.concatenate(all_lprior, axis=0),
            "log_likelihood": np.concatenate(all_llh, axis=0),
            "temperatures": self.emit_ladder,
            "acceptance": {
                "attempted_mutate": host(state.att_mut),
                "accepted_mutate": host(state.acc_mut),
                "attempted_exchange": host(state.att_exc),
                "accepted_exchange": host(state.acc_exc),
            },
            "evaluations": self.total_evaluations,
            "elapsed_seconds": elapsed,
            "sampling_seconds": sampling,
            "evals_per_second": evals_per_sec,
            "adaptation_records": adaptation_records,
            "adaptation_seconds": self.adaptation_seconds,
            "adaptation_boundaries": self.adaptation_boundaries,
            "adaptation_breakdown": self.adaptation_timings,
            "ensemble_shard": self._emit_shard,
            "num_ensembles": self.num_ensembles,
        }

    def _save_checkpoint(self, path: str, state: PTState, proposals, emitted: int):
        """The whole sampler state (io/checkpoint.py): `proposals` are the
        running segment's, self.proposals those a later run() starts from.
        Sharded, every rank calls it: the state is gathered, the primary
        writes the one complete file and the others wait for it."""
        from bcm3_tpu_torch.io.checkpoint import save_checkpoint

        save_checkpoint(
            path,
            state,
            self.proposals,
            self.blocks,
            emitted,
            self.adaptations_done,
            self.adaptation_iteration,
            live_proposals=proposals,
            generators={"device": self.generator, "choice": self._choice_generator},
            assigner=self._assigner,
            extra={
                "host_rng": self._host_rng.bit_generator.state,
                "clustering_iteration": self.clustering_iteration,
            },
            block=self._block,
        )

    def _restore_checkpoint(self, path: str):
        """Load a checkpoint into this sampler; returns the emitted count,
        the state and the running segment's proposals. The history's shape
        must be this sampler's (chains x history rows x variables). Sharded,
        every rank reads the file and keeps its rows, whether a sharded or
        an unsharded run wrote it."""
        from bcm3_tpu_torch.io.checkpoint import load_checkpoint

        p = load_checkpoint(path, self.device, self.dtype, block=self._block)
        shape = p["history_shape"]
        expected = (self.num_chains, self.history_size * self.num_variables)
        if shape != expected:
            raise ValueError(
                f"checkpoint {path} holds a history of shape {shape}, this "
                f"sampler's is {expected} (chains, history rows x variables): it was "
                "written with another num_chains, num_ensembles, history size or prior"
            )
        self.proposals = p["proposals"]
        self._set_blocks(p["blocks"])
        self.adaptations_done = p["adaptations_done"]
        self.adaptation_iteration = p["adaptation_iteration"]
        self._assigner = p["assigner"]
        self.generator.set_state(p["generators"]["device"])
        self._choice_generator.set_state(p["generators"]["choice"])
        self._host_rng.bit_generator.state = p["extra"]["host_rng"]
        self.clustering_iteration = p["extra"]["clustering_iteration"]
        return p["emitted"], p["state"], p["live_proposals"]

    def _gather_emitted(self, arr: np.ndarray) -> np.ndarray:
        """(S, E_local*L, ...) of every rank, joined along axis 1 in rank
        order: the whole population's emitted rows (per-rank emission)."""
        t = torch.from_numpy(np.ascontiguousarray(np.moveaxis(arr, 1, 0))).to(self.device)
        return np.moveaxis(collectives.all_gather_rows(t).cpu().numpy(), 0, 1)

    def _pool_ensembles(self, arr: np.ndarray) -> np.ndarray:
        """(S, E*L, ...) -> (S*E, L, ...): pool replica samples per
        temperature, sample-major, as the JAX package stores them (E is
        this rank's own ensembles under per-rank emission)."""
        L = self._emit_L
        E = arr.shape[1] // L
        S = arr.shape[0]
        rest = arr.shape[2:]
        return arr.reshape(S, E, L, *rest).reshape(S * E, L, *rest)

    def acceptance_rates(self, state: PTState):
        """Per-temperature (mutate, exchange) acceptance, pooled over
        ensembles (reference: SamplerPTChain.cpp LogStatistics:383-389);
        sharded, over every rank (a collective: every rank calls it)."""
        L = self.ladder_size

        def per_temp(t):
            return self._gather(t).to(torch.float64).reshape(-1, L).sum(0).cpu().numpy()

        att_m, acc_m = per_temp(state.att_mut), per_temp(state.acc_mut)
        att_e, acc_e = per_temp(state.att_exc), per_temp(state.acc_exc)
        return acc_m / np.maximum(att_m, 1.0), acc_e / np.maximum(att_e, 1.0)

    def _log_statistics(self, state: PTState):
        mut, exc = self.acceptance_rates(state)
        logger.info("Acceptance statistics:")
        logger.info("Temperature | Mutate (all) | Exchange (all)")
        for c in range(self.ladder_size):
            logger.info("%11.7f | %12.5f | %14.5f", self.ladder[c], mut[c], exc[c])
