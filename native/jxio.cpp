// janusx-tpu native host IO kernels.
//
// Device equivalent of the reference's Rust genotype IO layer
// (/root/reference/src/io/gfcore.rs VcfSnpIter, gfreader.rs): the host must
// keep the chips fed, and VCF GT parsing is the slowest host-side stage for
// text inputs. This C++ kernel parses a block of VCF data lines and packs
// dosage codes (0/1/2 = ALT count, 3 = missing; 4 samples/byte,
// little-endian 2-bit lanes — janusx_tpu.io.bitcodec convention) in one
// pass, plus the byte spans of the first five columns so Python can slice
// site metadata without re-tokenizing.
//
// Plain C ABI for ctypes; no Python headers needed.

#include <cstdint>
#include <cstring>

extern "C" {

// Returns the number of lines parsed (<= max_lines), or -(k+1) when line k
// is malformed (ends before the 9 fixed VCF columns — truncated or
// non-VCF content). `buf` holds newline-separated VCF data lines (no
// header lines).
// packed: (max_lines, nb) row-major with nb = (n_samples + 3) / 4, caller
// pre-sized; tail lanes of each row are set to code 3.
// field_off/field_len: (max_lines, 5) spans of CHROM POS ID REF ALT in buf.
long jx_vcf_parse_block(const char* buf, long len, long n_samples,
                        long max_lines, unsigned char* packed, long nb,
                        long* field_off, long* field_len) {
  long line = 0;
  long i = 0;
  while (i < len && line < max_lines) {
    // skip empty lines
    if (buf[i] == '\n') {
      ++i;
      continue;
    }
    long line_start = i;
    // first 5 fields: record spans; a line ending inside the fixed
    // columns is malformed (truncated download, non-VCF junk) — flag it
    // instead of emitting a phantom all-missing variant
    for (int f = 0; f < 5; ++f) {
      long start = i;
      while (i < len && buf[i] != '\t' && buf[i] != '\n') ++i;
      field_off[line * 5 + f] = start;
      field_len[line * 5 + f] = i - start;
      if (i >= len || buf[i] != '\t') return -(line + 1);
      ++i;
    }
    // skip QUAL FILTER INFO FORMAT
    for (int f = 0; f < 4; ++f) {
      while (i < len && buf[i] != '\t' && buf[i] != '\n') ++i;
      if (i >= len || buf[i] != '\t') return -(line + 1);
      ++i;
    }
    unsigned char* row = packed + line * nb;
    std::memset(row, 0xFF, (size_t)nb);  // all-missing default (code 3)
    long s = 0;
    while (s < n_samples && i < len && buf[i] != '\n') {
      // parse GT = first colon-separated subfield
      int a0 = -2, a1 = -2;  // -2 unset, -1 missing
      // allele 0
      if (buf[i] == '.') {
        a0 = -1;
        ++i;
      } else if (buf[i] >= '0' && buf[i] <= '9') {
        a0 = 0;
        while (i < len && buf[i] >= '0' && buf[i] <= '9') {
          a0 = a0 * 10 + (buf[i] - '0');
          ++i;
        }
      }
      if (i < len && (buf[i] == '/' || buf[i] == '|')) {
        ++i;
        if (i < len && buf[i] == '.') {
          a1 = -1;
          ++i;
        } else if (i < len && buf[i] >= '0' && buf[i] <= '9') {
          a1 = 0;
          while (i < len && buf[i] >= '0' && buf[i] <= '9') {
            a1 = a1 * 10 + (buf[i] - '0');
            ++i;
          }
        }
      }
      // skip the rest of the sample field
      while (i < len && buf[i] != '\t' && buf[i] != '\n') ++i;
      unsigned code;
      if (a0 == -2) {
        code = 3;  // unparseable
      } else if (a1 == -2) {
        // haploid: 0 -> 0, 1 -> 2, else missing
        code = (a0 == 0) ? 0u : (a0 == 1 ? 2u : 3u);
      } else if (a0 < 0 || a1 < 0 || a0 > 1 || a1 > 1) {
        code = 3;  // missing or multi-allelic index
      } else {
        code = (unsigned)(a0 + a1);
      }
      long byte = s >> 2;
      int shift = (int)((s & 3) << 1);
      row[byte] = (unsigned char)((row[byte] & ~(3u << shift)) | (code << shift));
      ++s;
      if (i < len && buf[i] == '\t') ++i;
    }
    // drain to end of line
    while (i < len && buf[i] != '\n') ++i;
    if (i < len) ++i;  // consume newline
    (void)line_start;
    ++line;
  }
  return line;
}

// Count data lines in a buffer (for inspect without parsing).
long jx_count_lines(const char* buf, long len) {
  long n = 0;
  for (long i = 0; i < len; ++i)
    if (buf[i] == '\n') ++n;
  if (len > 0 && buf[len - 1] != '\n') ++n;
  return n;
}

}  // extern "C"
