// lux-convert — text edge list -> .lux CSC binary.
//
// CLI parity with the reference converter (tools/converter.cc): flags
// -nv, -ne, -input, -output, plus -weighted (the reference has no weighted
// converter path; weighted .lux files come pre-built).  Implementation is
// the counting-sort pipeline in lux_io.cc, not a comparison sort.

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <vector>

extern "C" {
int lux_write_from_edges(const char*, uint32_t, uint64_t, const uint32_t*,
                         const uint32_t*, const int32_t*);
int64_t lux_parse_edge_text(const char*, uint64_t, uint32_t*, uint32_t*,
                            int32_t*);
}

int main(int argc, char** argv) {
  uint32_t nv = 0;
  uint64_t ne = 0;
  const char* input = nullptr;
  const char* output = nullptr;
  bool weighted = false;
  for (int i = 1; i < argc; i++) {
    if (!strcmp(argv[i], "-nv") && i + 1 < argc) nv = strtoul(argv[++i], 0, 10);
    else if (!strcmp(argv[i], "-ne") && i + 1 < argc)
      ne = strtoull(argv[++i], 0, 10);
    else if (!strcmp(argv[i], "-input") && i + 1 < argc) input = argv[++i];
    else if (!strcmp(argv[i], "-output") && i + 1 < argc) output = argv[++i];
    else if (!strcmp(argv[i], "-weighted")) weighted = true;
    else {
      fprintf(stderr, "unknown flag: %s\n", argv[i]);
      return 2;
    }
  }
  if (!nv || !ne || !input || !output) {
    fprintf(stderr,
            "usage: lux-convert -nv N -ne M -input edges.txt -output g.lux "
            "[-weighted]\n");
    return 2;
  }
  std::vector<uint32_t> src(ne), dst(ne);
  std::vector<int32_t> w(weighted ? ne : 0);
  int64_t got = lux_parse_edge_text(input, ne, src.data(), dst.data(),
                                    weighted ? w.data() : nullptr);
  if (got < 0) {
    fprintf(stderr, "parse failed: %s\n", strerror((int)-got));
    return 1;
  }
  if ((uint64_t)got != ne) {
    fprintf(stderr, "expected %llu edges, parsed %lld\n",
            (unsigned long long)ne, (long long)got);
    return 1;
  }
  int rc = lux_write_from_edges(output, nv, ne, src.data(), dst.data(),
                                weighted ? w.data() : nullptr);
  if (rc != 0) {
    fprintf(stderr, "write failed: %s\n", strerror(-rc));
    return 1;
  }
  printf("wrote %s: nv=%u ne=%llu%s\n", output, nv, (unsigned long long)ne,
         weighted ? " (weighted)" : "");
  return 0;
}
