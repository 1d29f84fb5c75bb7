"""Rate of PyTorch's own row gather on the card, by row count and row width.

``chip_smoke.py`` times ``torch.index_select`` beside the row-gather kernel
(``parallel_hnsw_tpu_torch/csrc/row_gather.cu``) at 32-byte rows (11b's
``reconstruct``: 50,331,648 rows of a 65,535 x 8 f32 codebook) and at 64-byte
rows (phase 10).  This script asks whether the library call's time there
follows the bytes or the rows: it times ``index_select`` with an int32 and an
int64 index, into a preallocated output, with a sorted index, ``table[idx]``
and ``embedding``, for 8- and 16-column f32 tables of 65,535 rows at several
row counts, and prints each time with its bytes per second and rows per
second.

Run on a CUDA machine from the repo root::

    python3 studies/index_select_rows.py
"""

import subprocess

import torch


def _median_ms(fn, reps: int = 5) -> float:
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return sorted(times)[reps // 2]


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("index_select_rows: no CUDA device")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    print(f"torch {torch.__version__} cuda {torch.version.cuda}")
    dev = torch.device("cuda:0")
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    for cols, rows in [(8, 1_572_864), (8, 16_777_216), (8, 50_331_648),
                       (16, 1_572_864), (16, 25_165_824), (100, 1_572_864)]:
        table = torch.randn(65_535, cols, device=dev, generator=gen)
        idx = torch.randint(0, 65_535, (rows,), device=dev, generator=gen, dtype=torch.int32)
        idx64, sidx = idx.long(), idx.sort().values
        out = torch.empty(rows, cols, device=dev)
        calls = {
            "index_select int32": lambda: torch.index_select(table, 0, idx),
            "index_select int64": lambda: torch.index_select(table, 0, idx64),
            "index_select out=": lambda: torch.index_select(table, 0, idx, out=out),
            "index_select sorted": lambda: torch.index_select(table, 0, sidx),
            "table[idx]": lambda: table[idx64],
            "embedding": lambda: torch.nn.functional.embedding(idx64, table),
        }
        nbytes = rows * (4 * cols + 4)
        for name, fn in calls.items():
            ms = _median_ms(fn)
            print(f"{cols:>3} cols x {rows:>10} rows  {name:<20} {ms:9.4f} ms  "
                  f"{nbytes / ms / 1e6:8.1f} GB/s  {rows / ms / 1e6:7.3f} G rows/s", flush=True)
        del table, idx, idx64, sidx, out


if __name__ == "__main__":
    main()
