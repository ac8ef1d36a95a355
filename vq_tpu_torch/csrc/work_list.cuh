// The work list of K6's step 1 (defined in ivf_matvec.cu), shared with
// K7 (ivf_probe.cu): a stable counting sort of the live entries
// i = p * nc + s of chunks [P, nc] by their bin (the chunk id), cut into
// tasks of up to task_entries entries of one bin. K6 sorts (pair, chain
// slot) entries by chunk, 32 a task; K7 sorts pairs by the bin of their
// chain's first chunk id (nc = 1 over its own key array), 4 a task: a
// quad of pairs.
#pragma once

#include <cuda_runtime.h>

namespace vqk {

// The scratch of the work list: tasks [max_tasks] int4 (bin, first work
// slot, entries, 0), max_tasks = n_bins + ceil(E / task_entries), at
// least the tasks there can be; then i32 table [n_bins, segs], totals
// [n_bins], offsets [n_bins + 1], task_off [n_bins + 1] (the last: all
// tasks), rank [E] and work [E]. s is 16-byte aligned.
struct WorkList {
  int4* tasks;
  int *table, *totals, *offsets, *task_off, *rank, *work;
  long long max_tasks;
  WorkList(int* s, long long entries, int n_bins, int segs, int task_entries) {
    max_tasks = n_bins + (entries + task_entries - 1) / task_entries;
    tasks = reinterpret_cast<int4*>(s);
    table = s + 4 * max_tasks;
    totals = table + (long long)n_bins * segs;
    offsets = totals + n_bins;
    task_off = offsets + n_bins + 1;
    rank = task_off + n_bins + 1;
    work = rank + entries;
  }
};

// Entry i is live when its bin c = chunks[i] lies in [0, n_bins) and
// (i % nc) * ch < cap. After the launches, bin c's live entries,
// ascending, are work[offsets[c] .. offsets[c + 1]), and its tasks hold
// them in order, task_entries at a time. Integer counts only: the same
// list on every run, and no host sync. Returns cudaGetLastError().
int work_list(const int* chunks, const WorkList& s, long long entries, int nc, int ch,
              int n_bins, long long cap, int seg_len, int segs, int task_entries,
              cudaStream_t st);

}  // namespace vqk
