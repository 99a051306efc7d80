"""The benchmark's one door into the program under test, ``demuxalot_tpu_torch``.

Everything else under ``bench_h100`` reads plain arrays. Here the draws
become the program's inputs (a genotype registry, per-chromosome
compressed calls, a barcode handler), the calls are packed with
``Demultiplexer.pack_dataset``, and the EM loop is the one
``Demultiplexer.learn_genotypes_core`` builds: ``models.demux._EMRun``
with the mix's clip, doublet prior and damping, pulled through
``_EMRun.device_iterations()`` with no end. A renamed ``_EMRun`` or
``device_iterations`` breaks this file, and with it the yardstick.
"""
from __future__ import annotations

import numpy as np

from demuxalot_tpu_torch.frontend.snp_counter import MOLECULE_DTYPE, SNP_CALL_DTYPE, CompressedSNPCalls
from demuxalot_tpu_torch.models.demux import Demultiplexer, _EMRun
from demuxalot_tpu_torch.models.genotypes import ProbabilisticGenotypes
from demuxalot_tpu_torch.utils.barcodes import BarcodeHandler

from .check import Iteration
from .generator import Draws, genotype_betas

UNBOUNDED = 1 << 62  # iterations the loop may run: the window ends it, not the count
BASES = ("A", "C")  # allele 0 and 1 of every SNP, registered in this order


def donor_names(n_donors: int) -> list:
    return [f"Donor{i + 1:02}" for i in range(n_donors)]


def inputs(draws: Draws, config: dict) -> tuple:
    """(genotypes, {"chr1": calls}, barcode handler): the draws as the program takes them."""
    genotypes = ProbabilisticGenotypes(donor_names(draws.n_donors), default_prior=config["default_prior"])
    for pos in range(draws.n_snps):
        for base in BASES:
            genotypes.get_variant_id("chr1", pos, base)
    genotypes = genotypes._with_betas(genotype_betas(draws, config))

    n_calls = draws.n_calls
    molecules = np.empty(n_calls, dtype=MOLECULE_DTYPE)
    molecules["compressed_cb"] = draws.cb
    molecules["compressed_ub"] = np.arange(n_calls, dtype=np.int32)
    molecules["p_group_misaligned"] = config["p_group_misaligned"]
    snp_calls = np.empty(n_calls, dtype=SNP_CALL_DTYPE)
    snp_calls["molecule_index"] = np.arange(n_calls, dtype=np.int32)
    snp_calls["snp_position"] = draws.snp
    snp_calls["base_index"] = draws.allele.astype(np.uint8)  # A = 0, C = 1 (utils.encoding.base_lookup)
    snp_calls["p_base_wrong"] = draws.q
    calls = CompressedSNPCalls()
    calls.molecules = molecules
    calls.snp_calls = snp_calls
    calls._finalized = True
    width = len(str(draws.n_barcodes))
    handler = BarcodeHandler([f"BC{b:0{width}d}" for b in range(draws.n_barcodes)])
    return genotypes, {"chr1": calls}, handler


def pack(calls: dict, genotypes):
    return Demultiplexer.pack_dataset(calls, genotypes)


class EMLoop:
    """The program's EM loop over one packed pool; :meth:`pull` runs one iteration (M-step, then E-step)."""

    def __init__(self, packed, genotypes, handler, traffic: dict, device: str):
        Demultiplexer.device = device
        Demultiplexer.aggregate_on_snps = traffic["likelihood"] == "aggregate_on_snps"
        self.run = _EMRun(packed, genotypes, handler, UNBOUNDED, traffic["p_genotype_clip"],
                          traffic["doublet_prior"], None, damping=traffic["damping"])
        self.iterations = self.run.device_iterations()
        self.state = None

    def pull(self) -> None:
        self.state = next(self.iterations)

    def snapshot(self) -> Iteration:
        """The last iteration on the host: the addition it entered with (registry order), its logits and posteriors."""
        state = self.state
        return Iteration(self.run.registry_addition(state), state.logits.cpu().numpy(), state.probs.cpu().numpy())

    def close(self) -> None:
        self.iterations.close()
        self.run = self.iterations = self.state = None
