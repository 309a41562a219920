// A stand-in NVIDIA driver for fake host trees (discovery/fake.py).
//
// The few CUDA driver and NVML entry points that discovery's driver path
// calls (sysfs.py driver_cards, tpudiscovery.cc driver_cards), over the
// cards listed in fake-gpus.txt beside the loaded library: one card a
// line, "<minor>|<uuid>|<bus id>|<name>", in NVML's index order; the CUDA
// ordinals run the other way, so a pairing by order, not by UUID, shows.
// fake.py copies the built library into a
// fake tree as both libcuda.so.1 and libnvidia-ml.so.1, so each tree
// reads its own file.  Every call reads the file afresh: no state.

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <dlfcn.h>
#include <fstream>
#include <string>
#include <vector>

namespace {

struct Card {
  unsigned minor = 0;
  std::string uuid, bus, name;
};

std::vector<Card> cards() {
  std::vector<Card> out;
  Dl_info info;
  if (!dladdr(reinterpret_cast<void *>(&cards), &info) || !info.dli_fname)
    return out;
  std::string path = info.dli_fname;
  path = path.substr(0, path.find_last_of('/') + 1) + "fake-gpus.txt";
  std::ifstream f(path);
  std::string line;
  while (std::getline(f, line)) {
    std::vector<std::string> parts;
    size_t start = 0, at;
    while ((at = line.find('|', start)) != std::string::npos) {
      parts.push_back(line.substr(start, at - start));
      start = at + 1;
    }
    parts.push_back(line.substr(start));
    if (parts.size() != 4) continue;
    Card c;
    c.minor = static_cast<unsigned>(std::stoul(parts[0]));
    c.uuid = parts[1];
    c.bus = parts[2];
    c.name = parts[3];
    out.push_back(c);
  }
  return out;
}

const int kInvalidDevice = 101;  // CUDA_ERROR_INVALID_DEVICE
const int kNvmlInvalidArgument = 2;

void copy_out(char *buf, int len, const std::string &s) {
  std::snprintf(buf, static_cast<size_t>(len), "%s", s.c_str());
}

}  // namespace

extern "C" {

int cuInit(unsigned) { return 0; }

int cuDeviceGetCount(int *n) {
  *n = static_cast<int>(cards().size());
  return 0;
}

int cuDeviceGet(int *dev, int ordinal) {
  int n = static_cast<int>(cards().size());
  if (ordinal < 0 || ordinal >= n) return kInvalidDevice;
  *dev = n - 1 - ordinal;
  return 0;
}

int cuDeviceGetUuid(unsigned char *out, int dev) {
  auto all = cards();
  if (dev < 0 || dev >= static_cast<int>(all.size())) return kInvalidDevice;
  std::string hex;
  for (char c : all[dev].uuid.substr(4))
    if (c != '-') hex += c;
  for (int i = 0; i < 16; i++)
    out[i] = static_cast<unsigned char>(
        std::stoul(hex.substr(2 * i, 2), nullptr, 16));
  return 0;
}

int cuDeviceGetPCIBusId(char *buf, int len, int dev) {
  auto all = cards();
  if (dev < 0 || dev >= static_cast<int>(all.size())) return kInvalidDevice;
  copy_out(buf, len, all[dev].bus);
  return 0;
}

int cuDeviceGetName(char *buf, int len, int dev) {
  auto all = cards();
  if (dev < 0 || dev >= static_cast<int>(all.size())) return kInvalidDevice;
  copy_out(buf, len, all[dev].name);
  return 0;
}

int nvmlInit_v2() { return 0; }

int nvmlShutdown() { return 0; }

int nvmlDeviceGetCount_v2(unsigned *n) {
  *n = static_cast<unsigned>(cards().size());
  return 0;
}

int nvmlDeviceGetHandleByIndex_v2(unsigned index, void **handle) {
  if (index >= cards().size()) return kNvmlInvalidArgument;
  *handle = reinterpret_cast<void *>(static_cast<uintptr_t>(index) + 1);
  return 0;
}

int nvmlDeviceGetUUID(void *handle, char *buf, unsigned len) {
  auto all = cards();
  auto index = reinterpret_cast<uintptr_t>(handle) - 1;
  if (index >= all.size()) return kNvmlInvalidArgument;
  copy_out(buf, static_cast<int>(len), all[index].uuid);
  return 0;
}

int nvmlDeviceGetMinorNumber(void *handle, unsigned *minor) {
  auto all = cards();
  auto index = reinterpret_cast<uintptr_t>(handle) - 1;
  if (index >= all.size()) return kNvmlInvalidArgument;
  *minor = all[index].minor;
  return 0;
}

}  // extern "C"
