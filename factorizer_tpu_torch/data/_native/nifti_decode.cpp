// Native NIfTI-1 decoder: gzip inflate + header parse + dtype conversion.
//
// The host-side data pipeline's hot path (the reference delegates this to
// nibabel/MONAI inside torch DataLoader workers).  Decoding a .nii.gz is
// zlib-inflate + cast dominated; doing it in C++ with a single pass and no
// intermediate Python objects roughly halves per-volume load time and
// releases the GIL for the loader thread pool.
//
// C API (ctypes-friendly):
//   ftx_nifti_load(path, &data, shape[8], affine[16], err[256]) -> 0 on success
//   ftx_free(ptr)
//
// Output: float32 voxel data in C (row-major) order with the NIfTI axis
// order preserved, i.e. data[i,j,k,...] = voxel(i,j,k,...) — matching the
// Fortran-ordered numpy reshape used by the Python reader.

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <vector>
#include <cmath>
#include <zlib.h>

namespace {

struct Header {
  int32_t sizeof_hdr;
  int16_t dim[8];
  int16_t datatype;
  int16_t bitpix;
  float pixdim[8];
  float vox_offset;
  float scl_slope;
  float scl_inter;
  int16_t qform_code;
  int16_t sform_code;
  float quatern[3];
  float qoffset[3];
  float srow[3][4];
  char magic[4];
  bool swap;
};

template <typename T>
T bswap(T v) {
  union {
    T val;
    uint8_t b[sizeof(T)];
  } s, d;
  s.val = v;
  for (size_t i = 0; i < sizeof(T); i++) d.b[i] = s.b[sizeof(T) - 1 - i];
  return d.val;
}

bool parse_header(const uint8_t* raw, size_t len, Header* h, char* err) {
  if (len < 348) {
    snprintf(err, 256, "header too short");
    return false;
  }
  std::memcpy(&h->sizeof_hdr, raw, 4);
  h->swap = false;
  if (h->sizeof_hdr != 348) {
    h->sizeof_hdr = bswap(h->sizeof_hdr);
    if (h->sizeof_hdr != 348) {
      snprintf(err, 256, "bad sizeof_hdr");
      return false;
    }
    h->swap = true;
  }
  auto rd16 = [&](size_t off) {
    int16_t v;
    std::memcpy(&v, raw + off, 2);
    return h->swap ? bswap(v) : v;
  };
  auto rdf = [&](size_t off) {
    float v;
    std::memcpy(&v, raw + off, 4);
    return h->swap ? bswap(v) : v;
  };
  for (int i = 0; i < 8; i++) h->dim[i] = rd16(40 + 2 * i);
  h->datatype = rd16(70);
  h->bitpix = rd16(72);
  for (int i = 0; i < 8; i++) h->pixdim[i] = rdf(76 + 4 * i);
  h->vox_offset = rdf(108);
  h->scl_slope = rdf(112);
  h->scl_inter = rdf(116);
  h->qform_code = rd16(252);
  h->sform_code = rd16(254);
  for (int i = 0; i < 3; i++) h->quatern[i] = rdf(256 + 4 * i);
  for (int i = 0; i < 3; i++) h->qoffset[i] = rdf(268 + 4 * i);
  for (int r = 0; r < 3; r++)
    for (int c = 0; c < 4; c++) h->srow[r][c] = rdf(280 + 16 * r + 4 * c);
  std::memcpy(h->magic, raw + 344, 4);
  if (std::memcmp(h->magic, "n+1", 3) != 0 && std::memcmp(h->magic, "ni1", 3) != 0) {
    snprintf(err, 256, "bad magic");
    return false;
  }
  return true;
}

bool read_file(const char* path, std::vector<uint8_t>* out, char* err) {
  size_t n = std::strlen(path);
  bool gz = n > 3 && std::strcmp(path + n - 3, ".gz") == 0;
  if (gz) {
    gzFile f = gzopen(path, "rb");
    if (!f) {
      snprintf(err, 256, "cannot open %s", path);
      return false;
    }
    gzbuffer(f, 1 << 20);
    out->clear();
    out->reserve(16u << 20);
    uint8_t buf[1 << 20];
    int got;
    while ((got = gzread(f, buf, sizeof(buf))) > 0) out->insert(out->end(), buf, buf + got);
    bool ok = got == 0;
    gzclose(f);
    if (!ok) {
      snprintf(err, 256, "gzip inflate failed for %s", path);
      return false;
    }
    return true;
  }
  FILE* f = std::fopen(path, "rb");
  if (!f) {
    snprintf(err, 256, "cannot open %s", path);
    return false;
  }
  std::fseek(f, 0, SEEK_END);
  long size = std::ftell(f);
  std::fseek(f, 0, SEEK_SET);
  out->resize(size);
  bool ok = std::fread(out->data(), 1, size, f) == (size_t)size;
  std::fclose(f);
  if (!ok) snprintf(err, 256, "short read on %s", path);
  return ok;
}

template <typename T>
void convert(const uint8_t* src, float* dst, int64_t count, bool swap, float slope,
             float inter) {
  const T* in = reinterpret_cast<const T*>(src);
  for (int64_t i = 0; i < count; i++) {
    T v = in[i];
    if (swap && sizeof(T) > 1) v = bswap(v);
    dst[i] = static_cast<float>(v) * slope + inter;
  }
}

}  // namespace

extern "C" {

// Returns 0 on success.  *data is malloc'd float32 in Fortran voxel order
// (i fastest); caller frees with ftx_free.  shape[0] = ndim, shape[1..] dims.
int ftx_nifti_load(const char* path, float** data, int64_t* shape, double* affine,
                   char* err) {
  std::vector<uint8_t> raw;
  if (!read_file(path, &raw, err)) return 1;

  Header h;
  if (!parse_header(raw.data(), raw.size(), &h, err)) return 2;

  int ndim = h.dim[0];
  if (ndim < 1 || ndim > 7) {
    snprintf(err, 256, "bad ndim %d", ndim);
    return 3;
  }
  int64_t count = 1;
  shape[0] = ndim;
  for (int i = 0; i < ndim; i++) {
    shape[1 + i] = h.dim[1 + i];
    count *= h.dim[1 + i];
  }
  size_t offset = (size_t)h.vox_offset;
  // NIfTI convention (matches nibabel): scl_slope == 0 disables scaling
  // entirely — the intercept must NOT be applied on its own.
  float slope = (h.scl_slope == 0.f || h.scl_slope == 1.f) ? 1.f : h.scl_slope;
  float inter = (h.scl_slope == 0.f) ? 0.f : h.scl_inter;

  *data = static_cast<float*>(std::malloc(sizeof(float) * count));
  if (!*data) {
    snprintf(err, 256, "oom (%lld voxels)", (long long)count);
    return 4;
  }
  const uint8_t* src = raw.data() + offset;
  size_t need = (size_t)count * (h.bitpix / 8);
  if (offset + need > raw.size()) {
    std::free(*data);
    snprintf(err, 256, "truncated voxel data");
    return 5;
  }
  switch (h.datatype) {
    case 2:  convert<uint8_t>(src, *data, count, h.swap, slope, inter); break;
    case 4:  convert<int16_t>(src, *data, count, h.swap, slope, inter); break;
    case 8:  convert<int32_t>(src, *data, count, h.swap, slope, inter); break;
    case 16: convert<float>(src, *data, count, h.swap, slope, inter); break;
    case 64: convert<double>(src, *data, count, h.swap, slope, inter); break;
    case 256: convert<int8_t>(src, *data, count, h.swap, slope, inter); break;
    case 512: convert<uint16_t>(src, *data, count, h.swap, slope, inter); break;
    case 768: convert<uint32_t>(src, *data, count, h.swap, slope, inter); break;
    default:
      std::free(*data);
      snprintf(err, 256, "unsupported datatype %d", h.datatype);
      return 6;
  }

  // affine: sform preferred, then qform, then pixdim diagonal
  double A[16] = {0};
  A[15] = 1.0;
  if (h.sform_code > 0) {
    for (int r = 0; r < 3; r++)
      for (int c = 0; c < 4; c++) A[r * 4 + c] = h.srow[r][c];
  } else if (h.qform_code > 0) {
    double b = h.quatern[0], cq = h.quatern[1], d = h.quatern[2];
    double a2 = 1.0 - (b * b + cq * cq + d * d);
    double a = a2 > 0 ? std::sqrt(a2) : 0.0;
    double R[3][3] = {
        {a * a + b * b - cq * cq - d * d, 2 * (b * cq - a * d), 2 * (b * d + a * cq)},
        {2 * (b * cq + a * d), a * a + cq * cq - b * b - d * d, 2 * (cq * d - a * b)},
        {2 * (b * d - a * cq), 2 * (cq * d + a * b), a * a + d * d - b * b - cq * cq}};
    double qfac = h.pixdim[0] < 0 ? -1.0 : 1.0;
    double S[3] = {h.pixdim[1], h.pixdim[2], qfac * h.pixdim[3]};
    for (int r = 0; r < 3; r++) {
      for (int c = 0; c < 3; c++) A[r * 4 + c] = R[r][c] * S[c];
      A[r * 4 + 3] = h.qoffset[r];
    }
  } else {
    for (int i = 0; i < 3; i++) A[i * 4 + i] = h.pixdim[1 + i];
  }
  std::memcpy(affine, A, sizeof(A));
  return 0;
}

void ftx_free(float* ptr) { std::free(ptr); }

}  // extern "C"
