// FrameStore index + mmap'd shards, shared by the two native readers
// (framestore_reader.cpp: libjpeg on the host; framestore_nvjpeg.cpp: nvJPEG
// on the card). The on-disk format is data/framestore.py's framestore-v1:
//
//   index.bin        per entry: u16 key_len | key utf-8 | u16 shard |
//                    u64 offset | u32 length
//   shard-00000.bin  concatenated values
#pragma once

#include <cstddef>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <unordered_map>
#include <vector>

#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

namespace fs {

struct Entry {
  uint16_t shard;
  uint64_t offset;
  uint32_t length;
};

struct Store {
  std::unordered_map<std::string, Entry> index;
  std::vector<const uint8_t*> maps;
  std::vector<size_t> sizes;

  // the value of key, or false when the key (or its shard) is missing
  bool find(const char* key, const uint8_t** ptr, size_t* size) const {
    if (!key || !key[0]) return false;
    auto it = index.find(key);
    if (it == index.end()) return false;
    const Entry& e = it->second;
    if (e.shard >= maps.size() || !maps[e.shard]) return false;
    *ptr = maps[e.shard] + e.offset;
    *size = e.length;
    return true;
  }
};

inline bool read_file(const std::string& path, std::vector<uint8_t>* out) {
  FILE* f = fopen(path.c_str(), "rb");
  if (!f) return false;
  fseek(f, 0, SEEK_END);
  long n = ftell(f);
  fseek(f, 0, SEEK_SET);
  out->resize(n);
  size_t got = fread(out->data(), 1, n, f);
  fclose(f);
  return got == static_cast<size_t>(n);
}

// Parse index.bin and mmap every shard of dir into *s; false when the
// index is unreadable or no shard exists.
inline bool open_store(const char* dir, Store* s) {
  std::string base(dir);
  std::vector<uint8_t> idx;
  if (!read_file(base + "/index.bin", &idx)) return false;
  size_t pos = 0, n = idx.size();
  while (pos + 2 <= n) {
    uint16_t klen;
    memcpy(&klen, idx.data() + pos, 2);
    pos += 2;
    if (pos + klen + 14 > n) break;
    std::string key(reinterpret_cast<const char*>(idx.data() + pos), klen);
    pos += klen;
    Entry e;
    memcpy(&e.shard, idx.data() + pos, 2);
    memcpy(&e.offset, idx.data() + pos + 2, 8);
    memcpy(&e.length, idx.data() + pos + 10, 4);
    pos += 14;
    s->index[std::move(key)] = e;  // a later duplicate wins, as in Python
  }
  // mmap shards until one is missing
  for (int i = 0;; ++i) {
    char name[64];
    snprintf(name, sizeof(name), "/shard-%05d.bin", i);
    std::string p = base + name;
    int fd = open(p.c_str(), O_RDONLY);
    if (fd < 0) break;
    struct stat st;
    fstat(fd, &st);
    const uint8_t* m = nullptr;
    if (st.st_size > 0) {
      m = static_cast<const uint8_t*>(
          mmap(nullptr, st.st_size, PROT_READ, MAP_PRIVATE, fd, 0));
      if (m == MAP_FAILED) m = nullptr;
    }
    close(fd);
    s->maps.push_back(m);
    s->sizes.push_back(st.st_size);
  }
  return !s->maps.empty();
}

inline void close_store(Store* s) {
  for (size_t i = 0; i < s->maps.size(); ++i)
    if (s->maps[i]) munmap(const_cast<uint8_t*>(s->maps[i]), s->sizes[i]);
  s->maps.clear();
  s->sizes.clear();
}

}  // namespace fs
