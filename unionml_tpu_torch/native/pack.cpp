// Native sequence packer: the first-fit algorithm of
// unionml_tpu_torch/ops/packing.py::pack_sequences, in C++. The port's own
// copy of unionml_tpu/native/pack.cpp, unchanged but for these comments.
//
// Packing is host-side input-pipeline work that runs per training job over the
// whole corpus; the Python loop is O(n_seqs * n_rows) with interpreter-speed
// constants, which at 10^5-10^6 sequences costs minutes before the first step
// reaches the card. This implementation keeps byte-identical outputs (same
// first-fit placement in insertion order, same segment/position layout) and
// adds a per-length scan cursor: a row that once rejected length L stays
// rejected forever (free space only shrinks, segment counts only grow), so the
// scan for each length resumes where it last stopped — near-linear amortized
// for clustered length distributions, exact first-fit always. Parity is pinned
// by tests/test_torch_native.py.
//
// C ABI (ctypes): caller pre-filters empty sequences, pre-truncates to seq_len,
// and concatenates tokens; allocation follows the TWO-PASS exact protocol —
// upk_count_rows first runs the identical first-fit placement loop to report
// the exact row count, the caller allocates exactly that many (rows, seq_len)
// output rows, then upk_pack fills them (and re-reports the row count, which
// the caller cross-checks). No worst-case allocation anywhere: (n_seqs,
// seq_len) x3 would be multi-GB at corpus scale.

#include <cstddef>
#include <cstdint>
#include <vector>

extern "C" {

// First-fit row count only (no writes): the Python wrapper calls this first
// and allocates EXACT outputs — a worst-case (n_seqs, seq_len) allocation
// would be multi-GB at the corpus scales this packer exists for. Runs the
// identical placement loop, so the subsequent upk_pack call fills exactly
// this many rows. Returns -1 on invalid arguments.
int64_t upk_count_rows(const int64_t* lengths,
                       int64_t n_seqs,
                       int64_t seq_len,
                       int64_t max_segments) {
  if (seq_len <= 0 || n_seqs < 0) return -1;
  struct Row {
    int64_t space;
    int64_t segments;
  };
  std::vector<Row> rows;
  std::vector<int64_t> scan_from(static_cast<size_t>(seq_len) + 1, 0);
  for (int64_t i = 0; i < n_seqs; ++i) {
    const int64_t len = lengths[i];
    if (len <= 0 || len > seq_len) return -1;
    int64_t placed = -1;
    int64_t r = scan_from[static_cast<size_t>(len)];
    for (; r < static_cast<int64_t>(rows.size()); ++r) {
      const Row& row = rows[static_cast<size_t>(r)];
      if (row.space >= len && (max_segments <= 0 || row.segments < max_segments)) {
        placed = r;
        break;
      }
    }
    scan_from[static_cast<size_t>(len)] = r;
    if (placed < 0) {
      rows.push_back(Row{seq_len, 0});
      placed = static_cast<int64_t>(rows.size()) - 1;
    }
    rows[static_cast<size_t>(placed)].space -= len;
    rows[static_cast<size_t>(placed)].segments += 1;
  }
  return rows.empty() ? 1 : static_cast<int64_t>(rows.size());
}

// Returns the number of rows written, or -1 on invalid arguments.
int64_t upk_pack(const int32_t* tokens,   // concatenated sequence tokens
                 const int64_t* lengths,  // per-sequence lengths, each in [1, seq_len]
                 int64_t n_seqs,
                 int64_t seq_len,
                 int32_t pad_id,
                 int64_t max_segments,    // 0 = unlimited
                 int32_t* input_ids,      // out: (max(n_seqs,1), seq_len)
                 int32_t* segment_ids,    // out: same shape
                 int32_t* positions) {    // out: same shape
  if (seq_len <= 0 || n_seqs < 0) return -1;

  struct Row {
    int64_t space;
    int64_t segments;
    int64_t offset;  // next free slot within the row
  };
  std::vector<Row> rows;
  rows.reserve(static_cast<size_t>(n_seqs));

  // scan_from[L] = first row index not yet REJECTED for length L. The reject
  // predicate (space < L, or segment cap reached) is monotone in time for a
  // fixed row, so resuming the scan here preserves exact first-fit placement.
  std::vector<int64_t> scan_from(static_cast<size_t>(seq_len) + 1, 0);

  const int32_t* cursor = tokens;
  for (int64_t i = 0; i < n_seqs; ++i) {
    const int64_t len = lengths[i];
    if (len <= 0 || len > seq_len) return -1;

    int64_t placed = -1;
    int64_t r = scan_from[static_cast<size_t>(len)];
    for (; r < static_cast<int64_t>(rows.size()); ++r) {
      const Row& row = rows[static_cast<size_t>(r)];
      if (row.space >= len && (max_segments <= 0 || row.segments < max_segments)) {
        placed = r;
        break;
      }
    }
    scan_from[static_cast<size_t>(len)] = r;  // rows before r are rejected for len, forever
    if (placed < 0) {
      rows.push_back(Row{seq_len, 0, 0});
      placed = static_cast<int64_t>(rows.size()) - 1;
    }

    Row& row = rows[static_cast<size_t>(placed)];
    int32_t* ids_out = input_ids + placed * seq_len + row.offset;
    int32_t* seg_out = segment_ids + placed * seq_len + row.offset;
    int32_t* pos_out = positions + placed * seq_len + row.offset;
    const int32_t segment = static_cast<int32_t>(row.segments + 1);
    for (int64_t t = 0; t < len; ++t) {
      ids_out[t] = cursor[t];
      seg_out[t] = segment;
      pos_out[t] = static_cast<int32_t>(t);
    }
    cursor += len;
    row.space -= len;
    row.segments += 1;
    row.offset += len;
  }

  // pad the tails of used rows (and the single all-padding row of an empty input)
  const int64_t n_rows = rows.empty() ? 1 : static_cast<int64_t>(rows.size());
  for (int64_t r = 0; r < n_rows; ++r) {
    const int64_t start =
        rows.empty() ? 0 : rows[static_cast<size_t>(r)].offset;
    for (int64_t t = start; t < seq_len; ++t) {
      input_ids[r * seq_len + t] = pad_id;
      segment_ids[r * seq_len + t] = 0;
      positions[r * seq_len + t] = 0;
    }
  }
  return n_rows;
}

}  // extern "C"
