// pfchunk: native mmap'd scene-chunk container for the data loader.
//
// The reference stores dataset chunks as torch-pickle archives
// (`*.torch`, loaded with torch.load at `src/dataset/dataset_re10k.py:121`),
// which drags the whole pickle machinery and a torch runtime into the input
// pipeline. This container replaces it for training-time ingestion:
//
//   header:  magic "PFCH" | version u32 | num_scenes u64
//   index:   per scene: key_off u64 | key_len u64 | cameras_off u64 |
//            num_frames u64 | images_index_off u64
//            (images index: per frame: jpeg_off u64 | jpeg_len u64)
//   payload: keys (utf-8), cameras (f32 [num_frames, 18]), raw JPEG bytes
//
// The reader memory-maps the file; camera rows and JPEG buffers are served
// as zero-copy pointers into the mapping. Conversion from .torch chunks is
// a one-time offline step (`pfchunk.py: convert_torch_chunk`).
//
// The port's copy of pf3plat_tpu/native/pfchunk.cc. Built by
// pf3plat_tpu_torch/native/pfchunk.py:build_library (g++, ctypes ABI).

#include <cstdint>
#include <cstdio>
#include <cstring>

#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

namespace {

constexpr uint32_t kMagic = 0x48434650;  // "PFCH" little-endian
// v2: 8-byte alignment guarantee for camera and image-index blocks.
constexpr uint32_t kVersion = 2;

struct Header {
  uint32_t magic;
  uint32_t version;
  uint64_t num_scenes;
};

struct SceneEntry {
  uint64_t key_off;
  uint64_t key_len;
  uint64_t cameras_off;
  uint64_t num_frames;
  uint64_t images_index_off;
};

struct ImageEntry {
  uint64_t jpeg_off;
  uint64_t jpeg_len;
};

struct Reader {
  int fd = -1;
  const uint8_t* base = nullptr;
  size_t size = 0;
  const Header* header = nullptr;
  const SceneEntry* scenes = nullptr;
};

}  // namespace

extern "C" {

// Returns an opaque handle, or null on failure.
void* pfchunk_open(const char* path) {
  int fd = ::open(path, O_RDONLY);
  if (fd < 0) return nullptr;
  struct stat st;
  if (fstat(fd, &st) != 0 || st.st_size < (long)sizeof(Header)) {
    ::close(fd);
    return nullptr;
  }
  void* mem = mmap(nullptr, st.st_size, PROT_READ, MAP_PRIVATE, fd, 0);
  if (mem == MAP_FAILED) {
    ::close(fd);
    return nullptr;
  }
  auto* r = new Reader();
  r->fd = fd;
  r->base = static_cast<const uint8_t*>(mem);
  r->size = st.st_size;
  r->header = reinterpret_cast<const Header*>(r->base);
  if (r->header->magic != kMagic || r->header->version != kVersion) {
    munmap(mem, st.st_size);
    ::close(fd);
    delete r;
    return nullptr;
  }
  r->scenes = reinterpret_cast<const SceneEntry*>(r->base + sizeof(Header));
  return r;
}

void pfchunk_close(void* handle) {
  auto* r = static_cast<Reader*>(handle);
  if (!r) return;
  munmap(const_cast<uint8_t*>(r->base), r->size);
  ::close(r->fd);
  delete r;
}

uint64_t pfchunk_num_scenes(void* handle) {
  return static_cast<Reader*>(handle)->header->num_scenes;
}

// Scene key: returns pointer into the mapping; length via out param.
const char* pfchunk_scene_key(void* handle, uint64_t scene, uint64_t* len) {
  auto* r = static_cast<Reader*>(handle);
  const SceneEntry& e = r->scenes[scene];
  *len = e.key_len;
  return reinterpret_cast<const char*>(r->base + e.key_off);
}

uint64_t pfchunk_num_frames(void* handle, uint64_t scene) {
  return static_cast<Reader*>(handle)->scenes[scene].num_frames;
}

// Zero-copy pointer to the scene's (num_frames, 18) float32 camera rows.
const float* pfchunk_cameras(void* handle, uint64_t scene) {
  auto* r = static_cast<Reader*>(handle);
  return reinterpret_cast<const float*>(r->base +
                                        r->scenes[scene].cameras_off);
}

// Zero-copy pointer to one frame's raw JPEG bytes.
const uint8_t* pfchunk_jpeg(void* handle, uint64_t scene, uint64_t frame,
                            uint64_t* len) {
  auto* r = static_cast<Reader*>(handle);
  const SceneEntry& e = r->scenes[scene];
  const auto* images =
      reinterpret_cast<const ImageEntry*>(r->base + e.images_index_off);
  *len = images[frame].jpeg_len;
  return r->base + images[frame].jpeg_off;
}

// Batched camera-row decode: 18-float rows -> c2w 4x4 + normalized K 3x3.
// Writes c2w (num_frames*16 floats) and intr (num_frames*9 floats).
// Returns 0 on success, -1 if a pose is singular.
int pfchunk_decode_poses(const float* rows, uint64_t num_frames, float* c2w,
                         float* intr) {
  for (uint64_t f = 0; f < num_frames; ++f) {
    const float* p = rows + f * 18;
    float* k = intr + f * 9;
    std::memset(k, 0, 9 * sizeof(float));
    k[0] = p[0];
    k[4] = p[1];
    k[2] = p[2];
    k[5] = p[3];
    k[8] = 1.0f;

    // w2c rows (3x4) -> invert the rigid transform analytically.
    const float* m = p + 6;
    float r00 = m[0], r01 = m[1], r02 = m[2], tx = m[3];
    float r10 = m[4], r11 = m[5], r12 = m[6], ty = m[7];
    float r20 = m[8], r21 = m[9], r22 = m[10], tz = m[11];
    float* o = c2w + f * 16;
    // R^T
    o[0] = r00; o[1] = r10; o[2] = r20;
    o[4] = r01; o[5] = r11; o[6] = r21;
    o[8] = r02; o[9] = r12; o[10] = r22;
    // -R^T t
    o[3] = -(r00 * tx + r10 * ty + r20 * tz);
    o[7] = -(r01 * tx + r11 * ty + r21 * tz);
    o[11] = -(r02 * tx + r12 * ty + r22 * tz);
    o[12] = 0.f; o[13] = 0.f; o[14] = 0.f; o[15] = 1.f;
  }
  return 0;
}

}  // extern "C"
