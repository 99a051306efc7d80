"""Command-line interface: the pipeline without writing Python.

The ``demux``, ``count`` and ``detect-snps`` commands of
``demuxalot_tpu.cli`` with the same flags, on this package's engine, plus
``--device`` (default ``cuda``) for the commands that run it::

    python -m demuxalot_tpu_torch demux --bam sample.bam --barcodes barcodes.csv \
        --vcf donors.vcf --output-dir out/ [--compact] [--sharded] [--device cuda]
    python -m demuxalot_tpu_torch count --bam sample.bam --barcodes barcodes.csv \
        --vcf donors.vcf --counts-dir counts/
    python -m demuxalot_tpu_torch detect-snps --bam sample.bam --barcodes barcodes.csv \
        --vcf donors.vcf --out new_snps.parquet --min-coverage 200 [--device cuda]

``demux --sharded`` runs the barcode-sharded engine
(``parallel.ShardedDemultiplexer``): over every visible card with
``--device cuda``, over one CPU shard with ``--device cpu``. Each
subcommand is a thin shell over the Python API; anything beyond
flag-plumbing belongs in the library.
"""
import argparse
import contextlib
import sys
from pathlib import Path


def _discover_donors(vcf: str | None, prior_betas: str | None) -> list:
    """Donor names from the inputs: VCF header samples + parquet columns."""
    names: list = []
    if vcf:
        from .bamio.vcf import VariantFile

        with VariantFile(vcf) as header:
            names.extend(header.sample_names)
    if prior_betas:
        import pyarrow.parquet as pq

        # schema-only read: the checkpoint is the full variants x donors
        # matrix and add_prior_betas will read the data itself
        index_levels = {"CHROM", "POS", "BASE"}
        names.extend(
            c for c in pq.read_schema(prior_betas).names
            if c not in index_levels and c not in names
            and not c.startswith("__index_level_")
        )
    if not names:
        raise SystemExit(
            "no donors found: the VCF has no sample columns and no "
            "--prior-betas was given; pass --donors explicitly"
        )
    return names


def _load_genotypes(args) -> "ProbabilisticGenotypes":
    from .models.genotypes import ProbabilisticGenotypes

    donors = (
        [d for d in args.donors.split(",") if d]
        if args.donors
        else _discover_donors(args.vcf, args.prior_betas)
    )
    store = ProbabilisticGenotypes(genotype_names=donors)
    if args.vcf:
        store.add_vcf(args.vcf)
    if args.prior_betas:
        store.add_prior_betas(args.prior_betas, prior_strength=args.prior_strength)
    if store.n_variants == 0:
        raise SystemExit("genotype store is empty; check --vcf/--prior-betas")
    return store


def _parse_bam(values: list):
    """One plain path, or a {rg: path} dict from repeated RG=PATH values."""
    if len(values) == 1:
        value = values[0]
        # a lone value is a plain path unless it unambiguously reads as
        # RG=existing-file (paths may legitimately contain '=')
        if "=" not in value or Path(value).exists():
            return value
        rg, _, path = value.partition("=")
        if rg and path and Path(path).exists():
            return {rg: path}
        return value
    mapping = {}
    for value in values:
        rg, sep, path = value.partition("=")
        if not sep or not rg or not path:
            raise SystemExit(
                f"--bam {value!r}: multiple BAMs must all use RG=PATH form "
                "(identities become (barcode, RG) pairs)"
            )
        mapping[rg] = path
    return mapping


def _load_barcodes(args) -> "BarcodeHandler":
    import pandas as pd

    from .utils.barcodes import BarcodeHandler

    frame = pd.read_csv(args.barcodes, header=None)
    barcodes = frame.iloc[:, 0].astype(str).tolist()
    # a second column carries RG tags (merged-BAM experiments: identities
    # are (barcode, RG) pairs, matching count_snps' {rg: path} input)
    rg_tags = None
    if frame.shape[1] > 1:
        column = frame.iloc[:, 1]
        if column.isna().any():
            raise SystemExit(
                f"{args.barcodes}: the RG column has "
                f"{int(column.isna().sum())} empty entries (a '(barcode, "
                "nan)' identity would never match any read) — fill every "
                "row or strip the trailing commas"
            )
        rg_tags = column.astype(str).tolist()
    return BarcodeHandler(barcodes, RG_tags=rg_tags, tag=args.barcode_tag)


def _cache_fingerprint(bam, store, whitelist) -> str:
    """Hash of everything the cached integer call columns are bound to.

    ``CompressedSNPCalls`` stores only compressed barcode slots and SNP
    positions — reusing them with a different whitelist (slot numbering
    shifts), BAM, or position set would silently scramble assignments.
    """
    import hashlib
    import json

    import numpy as np

    digest = hashlib.sha256()
    spec = bam if isinstance(bam, str) else sorted(bam.items())
    digest.update(json.dumps(spec).encode())
    digest.update(repr(whitelist.ordered_barcodes).encode())
    for chromosome, positions in sorted(store.get_chromosome2positions().items()):
        digest.update(chromosome.encode())
        digest.update(np.ascontiguousarray(np.sort(positions)).tobytes())
    return digest.hexdigest()


def _collect_counts(args, store, whitelist):
    """count_snps with an optional on-disk cache of the expensive scan.

    The cache carries a manifest fingerprinting the BAM spec, the barcode
    identity list, and the queried positions; it is written AFTER the call
    files, so a partial save never passes for a complete cache.
    """
    import json

    from .frontend.snp_counter import count_snps, load_snp_counts, save_snp_counts

    bam = _parse_bam(args.bam)
    cache = Path(args.counts_cache) if getattr(args, "counts_cache", None) else None
    fingerprint = _cache_fingerprint(bam, store, whitelist) if cache else None
    manifest = cache / "manifest.json" if cache else None
    if cache and manifest.exists():
        recorded = json.loads(manifest.read_text()).get("fingerprint")
        if recorded != fingerprint:
            raise SystemExit(
                f"{cache}: cached counts were scanned with different inputs "
                "(BAM, barcode whitelist, or SNP positions differ) — reusing "
                "them would misattribute molecules. Point --counts-cache at "
                "a fresh directory or delete this one."
            )
        print(f"# loading cached counts from {cache}", file=sys.stderr)
        return load_snp_counts(cache)
    if cache and any(cache.glob("*.calls.npz")):
        print(f"# {cache}: no manifest (partial or pre-manifest cache); "
              "re-scanning", file=sys.stderr)
    counts = count_snps(
        bamfile_location=bam,
        chromosome2positions=store.get_chromosome2positions(),
        barcode_handler=whitelist,
        joblib_n_jobs=args.jobs,
        joblib_verbosity=0,
    )
    if cache:
        save_snp_counts(counts, cache)
        manifest.write_text(json.dumps({"fingerprint": fingerprint}) + "\n")
    return counts


def _genotype_args(sub, require_bam: bool = True):
    sub.add_argument("--bam", required=require_bam, action="append",
                     help="coordinate-sorted, indexed BAM file; repeat as "
                          "--bam RG1=a.bam --bam RG2=b.bam for merged "
                          "experiments keyed by read group")
    sub.add_argument("--barcodes", required=True,
                     help="barcode whitelist csv(.gz), one barcode per line "
                          "(optional second column: RG tag per barcode)")
    sub.add_argument("--vcf", help="donor genotypes VCF (sample columns = donors)")
    sub.add_argument("--prior-betas",
                     help="betas parquet checkpoint (from a previous run / "
                          "save_betas)")
    sub.add_argument("--donors",
                     help="comma-separated donor subset (default: every donor "
                          "found in --vcf/--prior-betas)")
    sub.add_argument("--prior-strength", type=float, default=1.0,
                     help="scale applied to --prior-betas values (default 1)")
    sub.add_argument("--barcode-tag", default="CB",
                     help="BAM tag carrying the corrected cell barcode (default CB)")
    sub.add_argument("--jobs", type=int, default=-1,
                     help="process fan-out for the BAM scan (default: all cores)")


@contextlib.contextmanager
def _on_device(device: str):
    """Run the engine on ``device`` inside the block."""
    from .models.demux import Demultiplexer

    saved = Demultiplexer.device
    Demultiplexer.device = device
    try:
        yield
    finally:
        Demultiplexer.device = saved


def _cmd_demux(args) -> int:
    with _on_device(args.device):
        return _demux(args)


def _demux(args) -> int:
    import torch

    from .models.demux import Demultiplexer

    if args.sharded:
        # barcode-sharded; the same API surface, so the dispatch is just this
        from .parallel import ShardedDemultiplexer, make_mesh

        engine = ShardedDemultiplexer(make_mesh([torch.device("cpu")] if args.device == "cpu" else None))
        print(f"# sharding over {engine.n_shards} devices", file=sys.stderr)
    else:
        engine = Demultiplexer

    store = _load_genotypes(args)
    whitelist = _load_barcodes(args)
    counts = _collect_counts(args, store, whitelist)
    out = Path(args.output_dir)
    out.mkdir(parents=True, exist_ok=True)

    # pack once: the join, collapse and device tables are shared by every
    # entry point below (learn + the compact predict reuse one dataset)
    packed = Demultiplexer.pack_dataset(counts, store)

    learnt = None
    if not args.no_refine:
        learnt, probs = engine.learn_genotypes(
            packed, genotypes=store, barcode_handler=whitelist,
            n_iterations=args.n_iterations,
            p_genotype_clip=args.p_genotype_clip,
            doublet_prior=args.doublet_prior,
            damping=args.damping,
        )
        learnt.save_betas(out / "learnt_betas.parquet")

    if args.compact:
        # device top-k readback (assignment, runner-up, margin, posterior)
        # instead of the full posterior frames
        compact = engine.predict_posteriors_compact(
            packed, genotypes=(learnt if learnt is not None else store),
            barcode_handler=whitelist,
            p_genotype_clip=args.p_genotype_clip,
            doublet_prior=args.doublet_prior,
        )
        assignments = compact.to_dataframe()
        assignments.to_csv(out / "assignments.csv")
        print(f"# wrote {out}/assignments.csv (compact top-k; "
              f"{compact.bytes_moved} bytes read back)"
              + ("" if args.no_refine else ", learnt_betas.parquet"),
              file=sys.stderr)
        print(assignments["assignment"].value_counts().to_string(), file=sys.stderr)
        return 0

    if args.no_refine:
        logits, probs = engine.predict_posteriors(
            packed, genotypes=store, barcode_handler=whitelist,
            p_genotype_clip=args.p_genotype_clip,
            doublet_prior=args.doublet_prior,
        )
    else:
        logits = None

    probs.to_csv(out / "posteriors.csv")
    if logits is not None:
        logits.to_csv(out / "logits.csv")
    assignments = probs.idxmax(axis=1).to_frame("assignment")
    assignments["posterior"] = probs.max(axis=1)
    assignments.to_csv(out / "assignments.csv")
    print(f"# wrote {out}/posteriors.csv, assignments.csv"
          + ("" if args.no_refine else ", learnt_betas.parquet"),
          file=sys.stderr)
    print(assignments["assignment"].value_counts().to_string(), file=sys.stderr)
    return 0


def _cmd_count(args) -> int:
    from .frontend.snp_counter import save_snp_counts

    store = _load_genotypes(args)
    whitelist = _load_barcodes(args)
    args.counts_cache = None  # always a fresh scan; the output IS the cache
    counts = _collect_counts(args, store, whitelist)
    save_snp_counts(counts, args.counts_dir)
    for chromosome in sorted(counts):
        calls = counts[chromosome]
        print(f"{chromosome}\t{calls.n_molecules} molecules\t"
              f"{calls.n_snp_calls} calls")
    return 0


def _cmd_detect_snps(args) -> int:
    with _on_device(args.device):
        return _detect_snps(args)


def _detect_snps(args) -> int:
    from .models.snp_detection import detect_snps_positions

    store = _load_genotypes(args)
    whitelist = _load_barcodes(args)
    bam = _parse_bam(args.bam)
    if not isinstance(bam, str):
        raise SystemExit("detect-snps takes a single --bam (no RG=PATH form)")
    rows = detect_snps_positions(
        bam, store, whitelist,
        minimum_coverage=args.min_coverage,
        minimum_alternative_fraction=args.min_alternative_fraction,
        minimum_alternative_coverage=args.min_alternative_coverage,
        n_best_snps_per_donor=args.best_per_donor,
        n_additional_best_snps=args.additional_best,
        joblib_n_jobs=args.jobs,
        joblib_verbosity=0,
        result_beta_prior_filename=args.out,
    )
    print(f"# {len(rows)} positions selected -> {args.out}", file=sys.stderr)
    return 0


def _device_arg(sub) -> None:
    sub.add_argument("--device", default="cuda",
                     help="torch device of the engine (default cuda, which "
                          "needs a CUDA card; cpu runs the plain PyTorch path)")


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="demuxalot_tpu_torch",
        description="single-cell demultiplexing pipeline (PyTorch + CUDA)",
    )
    sub = parser.add_subparsers(dest="command", required=True)

    demux = sub.add_parser(
        "demux", help="BAM + barcodes + genotypes -> posterior assignments")
    _genotype_args(demux)
    demux.add_argument("--output-dir", required=True)
    demux.add_argument("--counts-cache",
                       help="directory for cached SNP counts (reused when "
                            "present, written after a fresh scan)")
    demux.add_argument("--no-refine", action="store_true",
                       help="skip EM refinement; posterior-only inference")
    demux.add_argument("--n-iterations", type=int, default=5)
    demux.add_argument("--doublet-prior", type=float, default=0.35)
    demux.add_argument("--p-genotype-clip", type=float, default=0.01)
    demux.add_argument("--damping", choices=["anchor", "auto"], default=None,
                       help="'anchor' restricts EM updates to prior-informed "
                            "variants (keeps refinement monotone on sparse "
                            "priors); 'auto' runs plain EM and falls back to "
                            "anchored when its confident assignments drift "
                            "from the anchored run")
    demux.add_argument("--compact", action="store_true",
                       help="write only the compact top-k assignment table "
                            "(device-side top-k readback; skips the full "
                            "posterior/logits frames — at product scale the "
                            "full f32 frame is hundreds of MB of pure "
                            "device->host transfer)")
    demux.add_argument("--sharded", action="store_true",
                       help="shard barcodes over every visible card (one CPU "
                            "shard with --device cpu); the same results")
    _device_arg(demux)
    demux.set_defaults(func=_cmd_demux)

    count = sub.add_parser(
        "count", help="scan the BAM once; save reusable per-chromosome counts")
    _genotype_args(count)
    count.add_argument("--counts-dir", required=True)
    count.set_defaults(func=_cmd_count)

    detect = sub.add_parser(
        "detect-snps", help="discover new discriminative SNPs from the data")
    _genotype_args(detect)
    detect.add_argument("--out", required=True,
                        help="positions-only parquet consumable via --prior-betas")
    detect.add_argument("--min-coverage", type=int, required=True)
    detect.add_argument("--min-alternative-fraction", type=float, default=0.01)
    detect.add_argument("--min-alternative-coverage", type=int, default=100)
    detect.add_argument("--best-per-donor", type=int, default=100)
    detect.add_argument("--additional-best", type=int, default=1000)
    _device_arg(detect)
    detect.set_defaults(func=_cmd_detect_snps)

    return parser


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    return args.func(args)


if __name__ == "__main__":
    raise SystemExit(main())
