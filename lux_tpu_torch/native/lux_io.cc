// lux_io — native graph I/O for lux_tpu.
//
// Role parity: the reference's offline converter (tools/converter.cc) and
// the per-partition loader task (pull_load_task_impl,
// core/pull_model.inl:253-320) are native C++; this library provides the
// same capabilities for the TPU framework, exposed to Python via ctypes.
//
// Design differences from the reference (not a translation):
//   * counting sort by destination (two O(E) passes) instead of
//     comparison sort — linear time, stable, no temporary edge structs;
//   * partial-range reads use pread64 with explicit offsets so concurrent
//     per-host loaders never share file positions;
//   * all functions return 0 on success / negative errno-style codes, no
//     aborts — error handling belongs to the Python layer.
//
// .lux layout (reference README.md:56-75):
//   u32 nv | u64 ne | u64 row_end[nv] | u32 col_src[ne] | i32 weight[ne]?

#include <algorithm>
#include <cerrno>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <fcntl.h>
#include <sys/stat.h>
#include <sys/types.h>
#include <unistd.h>
#include <vector>

namespace {

constexpr int64_t kHeaderBytes = 12;

// owner = last q with cuts[q] <= s, or num_parts when s is beyond the
// final cut (callers treat that as -EINVAL)
uint32_t owner_of(uint32_t s, const uint32_t* cuts, uint32_t num_parts) {
  uint32_t lo = 0, hi = num_parts;
  while (lo < hi) {
    uint32_t mid = (lo + hi) / 2;
    if (cuts[mid + 1] <= s) lo = mid + 1; else hi = mid;
  }
  return lo;
}

int64_t file_size(int fd) {
  struct stat st;
  if (fstat(fd, &st) != 0) return -errno;
  return st.st_size;
}

int read_exact(int fd, void* buf, int64_t nbytes, int64_t offset) {
  char* p = static_cast<char*>(buf);
  while (nbytes > 0) {
    ssize_t got = pread(fd, p, static_cast<size_t>(nbytes), offset);
    if (got < 0) {
      if (errno == EINTR) continue;
      return -errno;
    }
    if (got == 0) return -EIO;  // truncated file
    p += got;
    offset += got;
    nbytes -= got;
  }
  return 0;
}

int write_exact(int fd, const void* buf, int64_t nbytes) {
  const char* p = static_cast<const char*>(buf);
  while (nbytes > 0) {
    ssize_t put = write(fd, p, static_cast<size_t>(nbytes));
    if (put < 0) {
      if (errno == EINTR) continue;
      return -errno;
    }
    p += put;
    nbytes -= put;
  }
  return 0;
}

}  // namespace

extern "C" {

// Read the 12-byte header. Returns 0, fills nv/ne.
int lux_read_header(const char* path, uint32_t* nv, uint64_t* ne) {
  int fd = open(path, O_RDONLY);
  if (fd < 0) return -errno;
  unsigned char hdr[kHeaderBytes];
  int rc = read_exact(fd, hdr, kHeaderBytes, 0);
  close(fd);
  if (rc != 0) return rc;
  memcpy(nv, hdr, 4);
  memcpy(ne, hdr + 4, 8);
  return 0;
}

// Partial row-offset read: rows [row_lo, row_hi) of the u64 offset array
// (the equivalent of pull_load_task_impl's fseeko+fread of the part's
// row slice). out must hold (row_hi - row_lo) u64s.
int lux_read_rows(const char* path, uint64_t row_lo, uint64_t row_hi,
                  uint64_t* out) {
  int fd = open(path, O_RDONLY);
  if (fd < 0) return -errno;
  int rc = read_exact(fd, out, 8 * (int64_t)(row_hi - row_lo),
                      kHeaderBytes + 8 * (int64_t)row_lo);
  close(fd);
  return rc;
}

// Partial column (edge source) read: edges [col_lo, col_hi).
int lux_read_cols(const char* path, uint32_t nv, uint64_t col_lo,
                  uint64_t col_hi, uint32_t* out) {
  int fd = open(path, O_RDONLY);
  if (fd < 0) return -errno;
  int rc = read_exact(fd, out, 4 * (int64_t)(col_hi - col_lo),
                      kHeaderBytes + 8 * (int64_t)nv + 4 * (int64_t)col_lo);
  close(fd);
  return rc;
}

// Partial weight read; returns -ENODATA if the file has no weight block.
int lux_read_weights(const char* path, uint32_t nv, uint64_t ne,
                     uint64_t col_lo, uint64_t col_hi, int32_t* out) {
  int fd = open(path, O_RDONLY);
  if (fd < 0) return -errno;
  int64_t need = kHeaderBytes + 8 * (int64_t)nv + 4 * (int64_t)ne * 2;
  int64_t sz = file_size(fd);
  if (sz < need) {
    close(fd);
    return -ENODATA;
  }
  int rc = read_exact(fd, out, 4 * (int64_t)(col_hi - col_lo),
                      kHeaderBytes + 8 * (int64_t)nv + 4 * (int64_t)ne
                          + 4 * (int64_t)col_lo);
  close(fd);
  return rc;
}

// Convert an in-memory edge list to CSC and write a .lux file.
// Counting sort by dst: O(E) time, stable (preserves input edge order
// within a destination). weights may be null.
int lux_write_from_edges(const char* path, uint32_t nv, uint64_t ne,
                         const uint32_t* src, const uint32_t* dst,
                         const int32_t* weights) {
  std::vector<uint64_t> row_end(nv, 0);
  for (uint64_t e = 0; e < ne; e++) {
    if (dst[e] >= nv || src[e] >= nv) return -EINVAL;
    row_end[dst[e]]++;
  }
  // exclusive prefix -> insertion cursors; then convert to end offsets
  std::vector<uint64_t> cursor(nv, 0);
  uint64_t run = 0;
  for (uint32_t v = 0; v < nv; v++) {
    cursor[v] = run;
    run += row_end[v];
    row_end[v] = run;
  }
  std::vector<uint32_t> col(ne);
  std::vector<int32_t> wout(weights ? ne : 0);
  for (uint64_t e = 0; e < ne; e++) {
    uint64_t slot = cursor[dst[e]]++;
    col[slot] = src[e];
    if (weights) wout[slot] = weights[e];
  }
  int fd = open(path, O_WRONLY | O_CREAT | O_TRUNC, 0644);
  if (fd < 0) return -errno;
  int rc = 0;
  unsigned char hdr[kHeaderBytes];
  memcpy(hdr, &nv, 4);
  memcpy(hdr + 4, &ne, 8);
  if ((rc = write_exact(fd, hdr, kHeaderBytes)) == 0)
    if ((rc = write_exact(fd, row_end.data(), 8 * (int64_t)nv)) == 0)
      if ((rc = write_exact(fd, col.data(), 4 * (int64_t)ne)) == 0)
        if (weights)
          rc = write_exact(fd, wout.data(), 4 * (int64_t)ne);
  close(fd);
  return rc;
}

// Parse a whitespace text edge list ("src dst [weight]" per line) into
// preallocated arrays; returns the number of edges parsed or a negative
// error. Pass weights == null for unweighted files.
//
// Line-by-line (fgets + sscanf), NOT a stream-wide fscanf: an unweighted
// parse of a 3-column file must ignore the trailing column instead of
// desynchronizing (reading the weight as the next line's src) — this keeps
// the native path consistent with the NumPy fallback, which reads columns
// 0/1 per line. Blank lines and '#' comments are skipped like np.loadtxt.
int64_t lux_parse_edge_text(const char* path, uint64_t cap, uint32_t* src,
                            uint32_t* dst, int32_t* weights) {
  FILE* f = fopen(path, "r");
  if (!f) return -errno;
  uint64_t n = 0;
  char line[512];
  while (fgets(line, sizeof line, f)) {
    // a line longer than the buffer cannot be a valid edge line
    size_t len = strlen(line);
    if (len + 1 == sizeof line && line[len - 1] != '\n') {
      fclose(f);
      return -EINVAL;
    }
    const char* p = line;
    while (*p == ' ' || *p == '\t') p++;
    if (*p == '\0' || *p == '\n' || *p == '\r' || *p == '#') continue;
    if (n >= cap) break;
    unsigned long s, d;
    long w = 0;
    int got = sscanf(p, "%lu %lu %ld", &s, &d, &w);
    if (got < (weights ? 3 : 2)) {
      fclose(f);
      return -EINVAL;
    }
    src[n] = (uint32_t)s;
    dst[n] = (uint32_t)d;
    if (weights) weights[n] = (int32_t)w;
    n++;
  }
  int rc = ferror(f) ? -EIO : 0;
  fclose(f);
  return rc != 0 ? rc : (int64_t)n;
}

// Stable split of one part's edge slice by source-owner part — the host
// hot path of the ring / reduce_scatter / 2-D bucket builders (the role
// the reference's native Graph::Graph partition build plays,
// core/pull_model.inl:105-189, but keyed by source owner).  Counting sort
// with a binary search per edge: O(m log P + m), no comparison sort.
//   order[m]:  stable permutation grouping edge indices by owner
//   counts[P]: edges per owner
int lux_bucket_split(const uint32_t* srcs, uint64_t m, const uint32_t* cuts,
                     uint32_t num_parts, uint64_t* order, uint64_t* counts) {
  memset(counts, 0, 8 * (size_t)num_parts);
  std::vector<uint32_t> owner(m);
  for (uint64_t j = 0; j < m; j++) {
    const uint32_t lo = owner_of(srcs[j], cuts, num_parts);
    if (lo >= num_parts) return -EINVAL;  // src beyond cuts[num_parts]
    owner[j] = lo;
    counts[lo]++;
  }
  std::vector<uint64_t> cursor(num_parts);
  uint64_t run = 0;
  for (uint32_t p = 0; p < num_parts; p++) {
    cursor[p] = run;
    run += counts[p];
  }
  for (uint64_t j = 0; j < m; j++) order[cursor[owner[j]]++] = j;
  return 0;
}

// Per-part push-CSR build: group one part's edge slice by SOURCE vertex
// (stable), emitting the part's sorted unique sources, per-source edge
// offsets, and the CSR-ordered local-destination / weight arrays — the
// host hot path of graph/push_shards.py (the role the reference's
// unique-vertex init kernels play, components_gpu.cu:550-607, built on
// host here because the structure is static per partitioning).
//
// Counting sort keyed by source: two O(E) passes + an O(U log U) sort of
// the touched-source list, replacing the NumPy per-part stable argsort
// (O(E log E) with temporary index arrays).  The counts array is an
// nv-sized caller-owned scratch that must arrive zeroed; it leaves
// zeroed (only touched entries are reset), so one allocation serves all
// parts without O(P * nv) clearing.
//
//   srcs[n_e]:      slice col_idx[row_ptr[vlo] : row_ptr[vhi]]
//   row_ptr[n_v+1]: absolute offsets row_ptr[vlo..vhi]
//   weights[n_e]:   optional (null = unweighted); int32 in, float out
//   counts[nv]:     zeroed scratch (see above)
//   touched[cap_u]: scratch, cap_u >= min(n_e, nv)
//   uniq[cap_u], rp[cap_u+1], dst_out[n_e], w_out[n_e]: outputs;
//     dst_out/w_out are written as rows of the padded (P, e_pad) arrays
//   *n_uniq: number of distinct sources written to uniq/rp
int lux_push_part_build(const int32_t* srcs, const int64_t* row_ptr,
                        const int32_t* weights, uint64_t n_e, uint32_t n_v,
                        uint32_t nv, uint32_t* counts, uint32_t* touched,
                        int32_t* uniq, int32_t* rp, int32_t* dst_out,
                        float* w_out, uint64_t* n_uniq) {
  uint64_t nt = 0;
  for (uint64_t e = 0; e < n_e; e++) {
    const uint32_t s = (uint32_t)srcs[e];
    if (s >= nv) return -EINVAL;
    if (counts[s]++ == 0) touched[nt++] = s;
  }
  std::sort(touched, touched + nt);
  // prefix the sorted counts into rp; repurpose counts[] as insertion
  // cursors for the scatter pass
  uint32_t off = 0;
  rp[0] = 0;
  for (uint64_t i = 0; i < nt; i++) {
    const uint32_t s = touched[i];
    uniq[i] = (int32_t)s;
    const uint32_t c = counts[s];
    counts[s] = off;
    off += c;
    rp[i + 1] = (int32_t)off;
  }
  // scatter edges to their CSR slots, walking row_ptr so each edge's
  // part-local destination comes from its position in the slice (the
  // slice is dst-grouped CSC order, so this pass is also stable)
  const int64_t base = row_ptr[0];
  uint64_t e = 0;
  for (uint32_t v = 0; v < n_v; v++) {
    const uint64_t hi = (uint64_t)(row_ptr[v + 1] - base);
    if (hi > n_e) return -EINVAL;
    for (; e < hi; e++) {
      const uint32_t pos = counts[(uint32_t)srcs[e]]++;
      dst_out[pos] = (int32_t)v;
      if (weights) w_out[pos] = (float)weights[e];
    }
  }
  if (e != n_e) return -EINVAL;  // row_ptr slice inconsistent with n_e
  for (uint64_t i = 0; i < nt; i++) counts[touched[i]] = 0;
  *n_uniq = nt;
  return 0;
}

// Gathered-state source positions for one part's edge slice: for source
// s owned by part q (cuts[q] <= s < cuts[q+1]),
//   src_pos = q * nv_pad + (s - cuts[q])
// — the pull layout's padded all-gather addressing (graph/shards.py
// fill_part).  One O(m log P) pass in int32, replacing NumPy's
// searchsorted + int64 owner/offset temporaries (3 full-size
// intermediates on the host build hot path).
int lux_fill_src_pos(const int32_t* srcs, uint64_t m, const uint32_t* cuts,
                     uint32_t num_parts, uint32_t nv_pad, int32_t* out) {
  for (uint64_t j = 0; j < m; j++) {
    const uint32_t s = (uint32_t)srcs[j];
    const uint32_t lo = owner_of(s, cuts, num_parts);
    if (lo >= num_parts) return -EINVAL;
    out[j] = (int32_t)(lo * nv_pad + (s - cuts[lo]));
  }
  return 0;
}

// Block-CSR chunk fill for the Pallas kernel layout
// (ops/pallas_spmv.build_blockcsr): every edge lands at
//   flat = (chunk_start[block(dst)] + within/t_chunk) * t_chunk
//          + within % t_chunk
// where within = e - row_ptr[block_base].  One sequential O(ne) pass
// walking row_ptr (dst is implied by CSC position — never
// materialized), replacing the NumPy build's four O(ne) int64
// temporaries + three flat scatters.  Within a block the layout is
// slice-ordered, so the pass is forward-only and cache-friendly.
//   row_ptr[nv+1], src_pos[ne], w[ne] (nullable, pre-cast f32)
//   chunk_start[num_vblocks]: first chunk id of each vertex block
//   e_src[C*T] (pre-zeroed), e_dst[C*T] (pre-filled v_blk), e_w[C*T]
int lux_blockcsr_fill(const int64_t* row_ptr, uint32_t nv,
                      const int32_t* src_pos, const float* w, uint64_t ne,
                      uint32_t v_blk, uint32_t t_chunk,
                      const int64_t* chunk_start, int32_t* e_src,
                      int32_t* e_dst, float* e_w) {
  for (uint32_t v = 0; v < nv; v++) {
    const uint32_t b = v / v_blk;
    const int64_t block_lo = row_ptr[(uint64_t)b * v_blk];  // <= v < nv
    const int32_t dst_rel = (int32_t)(v - b * v_blk);
    const uint64_t lo = (uint64_t)row_ptr[v], hi = (uint64_t)row_ptr[v + 1];
    if (hi > ne || lo > hi) return -EINVAL;
    for (uint64_t e = lo; e < hi; e++) {
      const uint64_t within = e - (uint64_t)block_lo;
      const uint64_t flat =
          ((uint64_t)chunk_start[b] + within / t_chunk) * t_chunk
          + within % t_chunk;
      e_src[flat] = src_pos[e];
      e_dst[flat] = dst_rel;
      if (w) e_w[flat] = w[e];
    }
  }
  return 0;
}

// Out-degree histogram over an edge-source array (the native equivalent of
// pull_scan_task_impl's degree count, core/pull_model.inl:322-345).
int lux_count_degrees(const uint32_t* col, uint64_t ne, uint32_t nv,
                      uint32_t* degrees) {
  memset(degrees, 0, 4 * (int64_t)nv);
  for (uint64_t e = 0; e < ne; e++) {
    if (col[e] >= nv) return -EINVAL;
    degrees[col[e]]++;
  }
  return 0;
}

// One part-slice pass filling ALL owner buckets of the ring /
// reduce_scatter layouts (src_local, dst_local, head_flag, weights) —
// replaces the per-bucket Python fancy-indexing loop (O(P) array
// round-trips per part; 50-139 s at rmat24/P=16) with a single O(slice)
// scatter.  Works for both layouts via row_map/row_stride:
//   ring:    row_map[q] = q,                row_stride = B   (one (P,B) block)
//   scatter: row_map[q] = host row or -1,   row_stride = P*B (column p of the
//            (R,P,B) stack; caller offsets the base pointers by p*B)
// Edges arrive CSC-ordered (by destination); the stable per-owner cursor
// preserves that order inside each bucket, so head flags are computed on
// the fly against the bucket's previous destination.  The first padding
// slot of every materialized bucket is head-flagged (the
// segment_reduce_by_ends end-marker contract, parallel/ring.py
// mark_bucket_heads).  Outputs must arrive pre-padded (dst_local = V,
// src_local/weights = 0) — only real slots and the one pad flag are
// written.
int lux_bucket_fill(const uint32_t* srcs, const int64_t* row_ptr,
                    const int32_t* weights_in, uint64_t n_e, uint32_t n_v,
                    const uint32_t* cuts, uint32_t num_parts, uint64_t B,
                    const int64_t* row_map, uint64_t row_stride,
                    int32_t* src_local, int32_t* dst_local,
                    uint8_t* head_flag, float* w_out) {
  std::vector<uint64_t> cursor(num_parts, 0);
  std::vector<int32_t> prev(num_parts, -1);
  const int64_t base = row_ptr[0];
  uint64_t e = 0;
  for (uint32_t v = 0; v < n_v; v++) {
    const int64_t hi64 = row_ptr[v + 1] - base;
    if (hi64 < (int64_t)e || (uint64_t)hi64 > n_e) return -EINVAL;
    for (const uint64_t hi = (uint64_t)hi64; e < hi; e++) {
      const uint32_t s = srcs[e];
      const uint32_t q = owner_of(s, cuts, num_parts);
      if (q >= num_parts) return -EINVAL;
      const int64_t row = row_map[q];
      if (row < 0) continue;  // bucket not materialized on this host
      const uint64_t c = cursor[q]++;
      if (c >= B) return -EOVERFLOW;
      const size_t at = (size_t)row * row_stride + c;
      src_local[at] = (int32_t)(s - cuts[q]);
      dst_local[at] = (int32_t)v;
      head_flag[at] = (c == 0) || (prev[q] != (int32_t)v);
      prev[q] = (int32_t)v;
      if (weights_in) w_out[at] = (float)weights_in[e];
    }
  }
  if (e != n_e) return -EINVAL;
  for (uint32_t q = 0; q < num_parts; q++) {
    const int64_t row = row_map[q];
    if (row >= 0 && cursor[q] < B)
      head_flag[(size_t)row * row_stride + cursor[q]] = 1;
  }
  return 0;
}

}  // extern "C"
