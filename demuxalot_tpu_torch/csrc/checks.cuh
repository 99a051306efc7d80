// checks.cu's host launchers (its kernels say what each checks): each launches on `stream`, traps on a bad index
// before anything reads through it, and returns cudaGetLastError().
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

int demux_check_index(const int32_t* idx, int64_t n, int64_t limit, cudaStream_t stream);
int demux_check_csr(const int64_t* row_ptr, int64_t n_rows, int64_t n_entries, cudaStream_t stream);
int demux_check_schedule(const int32_t* schedule, int64_t n_entries, int entry, int n_blocks, int n_pg,
                         cudaStream_t stream);
