"""Tiny sizes at which the tests drive a cell's code on the CPU."""
from .harness import load_cell

TINY = dict(n_barcodes=300, n_donors=6, n_snps=512, calls_per_barcode=24)  # n_snps: a multiple of the stride
CELLS = ("pbmc32_65k.em_percall", "pbmc32_65k.em_aggregate", "pbmc32_65k.em_singlets")


def tiny_cell(name: str):
    """The cell ``name`` with its pool cut to :data:`TINY`; its mix, limits and metrics as they are."""
    cell = load_cell(name)
    cell.config.update(TINY)
    return cell
