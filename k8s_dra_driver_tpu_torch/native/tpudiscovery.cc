// Sysfs/devfs/env discovery of TPU chips and NVIDIA cards — native
// implementation.
//
// The port's own shim (k8s_dra_driver_tpu_torch/native), built by
// utils/nativebuild.py into build/native/libtpudiscovery.so.  It must
// produce byte-identical facts to discovery/sysfs.py, accel-class path
// and NVIDIA path alike; tests/test_torch_native_discovery.py diffs the
// two outputs field by field on fake trees, and chip_smoke.py on the
// live H100.
//
// NVIDIA cards come from PCI sysfs plus the driver's procfs entry
// (/proc/driver/nvidia/gpus/<bus>/information) or, where PCI sysfs shows
// no NVIDIA device but /dev/nvidiactl exists, from the driver's own
// libraries, opened with dlopen under host_root: NVML
// (libnvidia-ml.so.1, beside libcuda.so.1) for each card's minor and
// UUID, the CUDA driver for the bus id and name of the device with that
// UUID (sysfs.py driver_cards).
//
// Contract (C ABI, see tpu_discover below):
//   host_root  — filesystem prefix ("/" or a /host mount)
//   gens_spec  — generation table, one per line:
//                name|product|cores|hbm_bytes|pci_id[,pci_id...]
//                (canonical source: discovery/topology.py GENERATIONS;
//                the pci field may be empty)
//   env_spec   — environment, KEY=VALUE lines (only TPU_* + HOSTNAME
//                are read)
//   out/out_len— JSON result buffer; returns required length, -1 on
//                error, -2 on a host that shows both kinds of device
//                (error text in out)
//
// Output JSON mirrors HostTopology: {hostname, libtpu_path, slice:
// {...}|null, chips: [{index, uuid, generation, coord:[x,y,z],
// dev_paths, pci_address, numa_node}]}.

#include <algorithm>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <dirent.h>
#include <dlfcn.h>
#include <fstream>
#include <map>
#include <sstream>
#include <string>
#include <sys/stat.h>
#include <vector>

#include <limits.h>
#include <stdlib.h>
#include <unistd.h>

namespace {

// ---------------------------------------------------------------------------
// SHA-256 (for serial-less UUID fallback; must match Python hashlib)
// ---------------------------------------------------------------------------

struct Sha256 {
  uint32_t h[8] = {0x6a09e667, 0xbb67ae85, 0x3c6ef372, 0xa54ff53a,
                   0x510e527f, 0x9b05688c, 0x1f83d9ab, 0x5be0cd19};
  uint64_t bits = 0;
  unsigned char block[64];
  size_t fill = 0;

  static uint32_t rotr(uint32_t v, int n) {
    return (v >> n) | (v << (32 - n));
  }

  void compress(const unsigned char *p) {
    static const uint32_t K[64] = {
        0x428a2f98, 0x71374491, 0xb5c0fbcf, 0xe9b5dba5, 0x3956c25b,
        0x59f111f1, 0x923f82a4, 0xab1c5ed5, 0xd807aa98, 0x12835b01,
        0x243185be, 0x550c7dc3, 0x72be5d74, 0x80deb1fe, 0x9bdc06a7,
        0xc19bf174, 0xe49b69c1, 0xefbe4786, 0x0fc19dc6, 0x240ca1cc,
        0x2de92c6f, 0x4a7484aa, 0x5cb0a9dc, 0x76f988da, 0x983e5152,
        0xa831c66d, 0xb00327c8, 0xbf597fc7, 0xc6e00bf3, 0xd5a79147,
        0x06ca6351, 0x14292967, 0x27b70a85, 0x2e1b2138, 0x4d2c6dfc,
        0x53380d13, 0x650a7354, 0x766a0abb, 0x81c2c92e, 0x92722c85,
        0xa2bfe8a1, 0xa81a664b, 0xc24b8b70, 0xc76c51a3, 0xd192e819,
        0xd6990624, 0xf40e3585, 0x106aa070, 0x19a4c116, 0x1e376c08,
        0x2748774c, 0x34b0bcb5, 0x391c0cb3, 0x4ed8aa4a, 0x5b9cca4f,
        0x682e6ff3, 0x748f82ee, 0x78a5636f, 0x84c87814, 0x8cc70208,
        0x90befffa, 0xa4506ceb, 0xbef9a3f7, 0xc67178f2};
    uint32_t w[64];
    for (int i = 0; i < 16; i++)
      w[i] = (uint32_t(p[i * 4]) << 24) | (uint32_t(p[i * 4 + 1]) << 16) |
             (uint32_t(p[i * 4 + 2]) << 8) | uint32_t(p[i * 4 + 3]);
    for (int i = 16; i < 64; i++) {
      uint32_t s0 = rotr(w[i - 15], 7) ^ rotr(w[i - 15], 18) ^ (w[i - 15] >> 3);
      uint32_t s1 = rotr(w[i - 2], 17) ^ rotr(w[i - 2], 19) ^ (w[i - 2] >> 10);
      w[i] = w[i - 16] + s0 + w[i - 7] + s1;
    }
    uint32_t a = h[0], b = h[1], c = h[2], d = h[3], e = h[4], f = h[5],
             g = h[6], hh = h[7];
    for (int i = 0; i < 64; i++) {
      uint32_t S1 = rotr(e, 6) ^ rotr(e, 11) ^ rotr(e, 25);
      uint32_t ch = (e & f) ^ (~e & g);
      uint32_t t1 = hh + S1 + ch + K[i] + w[i];
      uint32_t S0 = rotr(a, 2) ^ rotr(a, 13) ^ rotr(a, 22);
      uint32_t maj = (a & b) ^ (a & c) ^ (b & c);
      uint32_t t2 = S0 + maj;
      hh = g; g = f; f = e; e = d + t1;
      d = c; c = b; b = a; a = t1 + t2;
    }
    h[0] += a; h[1] += b; h[2] += c; h[3] += d;
    h[4] += e; h[5] += f; h[6] += g; h[7] += hh;
  }

  void update(const void *data, size_t len) {
    const unsigned char *p = static_cast<const unsigned char *>(data);
    bits += uint64_t(len) * 8;
    while (len > 0) {
      size_t take = std::min(len, sizeof(block) - fill);
      memcpy(block + fill, p, take);
      fill += take; p += take; len -= take;
      if (fill == sizeof(block)) { compress(block); fill = 0; }
    }
  }

  std::string hexdigest() {
    uint64_t total = bits;
    block[fill++] = 0x80;
    if (fill > 56) {
      memset(block + fill, 0, sizeof(block) - fill);
      compress(block);
      fill = 0;
    }
    memset(block + fill, 0, 56 - fill);
    for (int i = 0; i < 8; i++)
      block[56 + i] = (total >> (56 - 8 * i)) & 0xff;
    compress(block);
    char out[65];
    for (int i = 0; i < 8; i++) snprintf(out + i * 8, 9, "%08x", h[i]);
    return std::string(out, 64);
  }
};

std::string sha256_hex(const std::string &s) {
  Sha256 d;
  d.update(s.data(), s.size());
  return d.hexdigest();
}

// ---------------------------------------------------------------------------
// small helpers
// ---------------------------------------------------------------------------

const char *kGooglePciVendor = "0x1ae0";

std::string read_file_trim(const std::string &path) {
  std::ifstream f(path);
  if (!f.good()) return "";
  std::stringstream ss;
  ss << f.rdbuf();
  std::string s = ss.str();
  while (!s.empty() && (s.back() == '\n' || s.back() == '\r' ||
                        s.back() == ' ' || s.back() == '\t'))
    s.pop_back();
  size_t i = 0;
  while (i < s.size() && (s[i] == ' ' || s[i] == '\t')) i++;
  return s.substr(i);
}

std::string lower(std::string s) {
  std::transform(s.begin(), s.end(), s.begin(), ::tolower);
  return s;
}

bool starts_with(const std::string &s, const std::string &pre) {
  return s.rfind(pre, 0) == 0;
}

// Python's str.split(sep): empty fields kept, a trailing one too.
std::vector<std::string> split(const std::string &s, char sep) {
  std::vector<std::string> out;
  size_t start = 0;
  while (true) {
    size_t at = s.find(sep, start);
    if (at == std::string::npos) {
      out.push_back(s.substr(start));
      return out;
    }
    out.push_back(s.substr(start, at - start));
    start = at + 1;
  }
}

std::string trim(const std::string &s) {
  size_t a = 0, b = s.size();
  while (a < b && isspace(static_cast<unsigned char>(s[a]))) a++;
  while (b > a && isspace(static_cast<unsigned char>(s[b - 1]))) b--;
  return s.substr(a, b - a);
}

bool all_digits(const std::string &s) {
  if (s.empty()) return false;
  for (char c : s)
    if (!isdigit(static_cast<unsigned char>(c))) return false;
  return true;
}

std::string join_ints(const std::vector<int> &v) {  // Python list repr
  std::string out = "[";
  for (size_t i = 0; i < v.size(); i++) {
    if (i) out += ", ";
    out += std::to_string(v[i]);
  }
  return out + "]";
}

std::string json_escape(const std::string &s) {
  std::string out;
  for (char c : s) {
    switch (c) {
      case '"': out += "\\\""; break;
      case '\\': out += "\\\\"; break;
      case '\n': out += "\\n"; break;
      case '\t': out += "\\t"; break;
      default:
        if (static_cast<unsigned char>(c) < 0x20) {
          char buf[8];
          snprintf(buf, sizeof(buf), "\\u%04x", c);
          out += buf;
        } else {
          out += c;
        }
    }
  }
  return out;
}

struct Generation {
  std::string name, product;
  int cores = 1;
  long long hbm = 0;
  std::vector<std::string> pci_ids;
};

struct Shape { int x = 1, y = 1, z = 1; int n() const { return x * y * z; } };

bool parse_bounds(const std::string &s, Shape *out) {
  // "2,2,1" style
  auto parts = split(s, ',');
  if (parts.empty() || parts.size() > 3) return false;
  int v[3] = {1, 1, 1};
  for (size_t i = 0; i < parts.size(); i++) {
    v[i] = atoi(parts[i].c_str());
    if (v[i] < 1) return false;
  }
  out->x = v[0]; out->y = v[1]; out->z = v[2];
  return true;
}

bool parse_shape(const std::string &s, Shape *out) {
  // "4x4" / "2x2x4" style, else bounds style
  if (s.find('x') == std::string::npos) return parse_bounds(s, out);
  auto parts = split(s, 'x');
  if (parts.empty() || parts.size() > 3) return false;
  int v[3] = {1, 1, 1};
  for (size_t i = 0; i < parts.size(); i++) {
    v[i] = atoi(parts[i].c_str());
    if (v[i] < 1) return false;
  }
  out->x = v[0]; out->y = v[1]; out->z = v[2];
  return true;
}

// Worker's host-box origin; x-fastest tiling, same as
// discovery/sysfs.py host_origin.
void host_origin(int worker_id, const Shape &hb, const Shape &topo,
                 int *ox, int *oy, int *oz) {
  int hx = std::max(topo.x / hb.x, 1);
  int hy = std::max(topo.y / hb.y, 1);
  *ox = (worker_id % hx) * hb.x;
  *oy = ((worker_id / hx) % hy) * hb.y;
  *oz = (worker_id / (hx * hy)) * hb.z;
}

const char *kLibtpuSearch[] = {
    "usr/lib/libtpu.so",
    "usr/local/lib/libtpu.so",
    "lib/libtpu.so",
    "home/kubernetes/bin/libtpu.so",
};

bool file_exists(const std::string &p) {
  struct stat st;
  return stat(p.c_str(), &st) == 0;
}

bool dir_exists(const std::string &p) {
  struct stat st;
  return stat(p.c_str(), &st) == 0 && S_ISDIR(st.st_mode);
}

bool regular_file(const std::string &p) {
  struct stat st;
  return stat(p.c_str(), &st) == 0 && S_ISREG(st.st_mode);
}

std::vector<std::string> list_dir(const std::string &p) {
  std::vector<std::string> out;
  DIR *d = opendir(p.c_str());
  if (!d) return out;
  while (dirent *e = readdir(d)) {
    std::string name = e->d_name;
    if (name != "." && name != "..") out.push_back(name);
  }
  closedir(d);
  std::sort(out.begin(), out.end());
  return out;
}

// discovery/sysfs.py _accel_index: "accel<digits>" or bare "accel" (0)
bool accel_index(const std::string &name, int *index) {
  if (!starts_with(name, "accel")) return false;
  std::string suffix = name.substr(5);
  if (!suffix.empty() && !all_digits(suffix)) return false;
  *index = suffix.empty() ? 0 : atoi(suffix.c_str());
  return true;
}

// -- NVIDIA ------------------------------------------------------------------

const char *kNvidiaPciVendor = "0x10de";

const char *kLibcudaSearch[] = {
    "usr/lib/x86_64-linux-gnu/libcuda.so.1",
    "usr/local/nvidia/lib64/libcuda.so.1",
    "usr/lib64/libcuda.so.1",
    "usr/lib/libcuda.so.1",
};

// sysfs.py nvidia_product_name
std::string product_name(const std::string &model) {
  std::string out, word;
  std::stringstream ss(lower(model));
  while (ss >> word) out += (out.empty() ? "" : "-") + word;
  return out;
}

// sysfs.py normalize_bus_id
std::string normalize_bus_id(const std::string &bus) {
  std::string s = trim(bus);
  size_t colon = s.find(':');
  std::string domain = s.substr(0, colon);
  std::string rest = colon == std::string::npos ? "" : s.substr(colon + 1);
  char buf[16];
  snprintf(buf, sizeof(buf), "%04lx", strtoul(domain.c_str(), nullptr, 16));
  return std::string(buf) + ":" + lower(rest);
}

// sysfs.py _GPU_UUID: GPU-8-4-4-4-12 hex digits
bool gpu_uuid(const std::string &u) {
  static const int groups[5] = {8, 4, 4, 4, 12};
  if (!starts_with(u, "GPU-")) return false;
  size_t at = 4;
  for (int g = 0; g < 5; g++) {
    if (g) {
      if (at >= u.size() || u[at] != '-') return false;
      at++;
    }
    for (int i = 0; i < groups[g]; i++, at++)
      if (at >= u.size() || !isxdigit(static_cast<unsigned char>(u[at])))
        return false;
  }
  return at == u.size();
}

// "Key: value" lines of a driver information file (sysfs.py _information)
bool read_information(const std::string &path,
                      std::map<std::string, std::string> *out) {
  std::ifstream f(path);
  if (!f.good()) return false;
  std::string line;
  while (std::getline(f, line)) {
    size_t colon = line.find(':');
    if (colon == std::string::npos) continue;
    (*out)[trim(line.substr(0, colon))] = trim(line.substr(colon + 1));
  }
  return true;
}

// sysfs.py _nvidia_pci: bus ids of NVIDIA display-class PCI devices
std::vector<std::string> nvidia_pci(const std::string &base) {
  std::vector<std::string> out;
  for (const auto &name : list_dir(base)) {
    std::string dir = base + "/" + name;
    if (lower(read_file_trim(dir + "/vendor")) != kNvidiaPciVendor) continue;
    if (!starts_with(lower(read_file_trim(dir + "/class")), "0x03")) continue;
    out.push_back(name);
  }
  return out;
}

struct DriverCard {
  int minor;
  std::string uuid, bus, name;
};

// sysfs.py driver_cards, through dlopen
bool driver_cards(const std::string &libcuda, const std::string &nvml,
                  std::vector<DriverCard> *cards, std::string *err) {
  void *cu = dlopen(libcuda.c_str(), RTLD_NOW | RTLD_LOCAL);
  if (!cu) { *err = std::string("cannot load ") + libcuda; return false; }
  void *nv = dlopen(nvml.c_str(), RTLD_NOW | RTLD_LOCAL);
  if (!nv) { *err = std::string("cannot load ") + nvml; return false; }
  typedef int (*Init)(unsigned);
  typedef int (*Count)(int *);
  typedef int (*Get)(int *, int);
  typedef int (*Uuid)(unsigned char *, int);
  typedef int (*Str)(char *, int, int);
  typedef int (*NvVoid)();
  typedef int (*NvCount)(unsigned *);
  typedef int (*NvHandle)(unsigned, void **);
  typedef int (*NvMinor)(void *, unsigned *);
  typedef int (*NvUuid)(void *, char *, unsigned);
  auto sym = [&](void *lib, const char *name) -> void * {
    void *p = dlsym(lib, name);
    if (!p) *err = std::string("missing symbol ") + name;
    return p;
  };
  auto cuInit = (Init)sym(cu, "cuInit");
  auto cuCount = (Count)sym(cu, "cuDeviceGetCount");
  auto cuGet = (Get)sym(cu, "cuDeviceGet");
  auto cuUuid = (Uuid)sym(cu, "cuDeviceGetUuid");
  auto cuBus = (Str)sym(cu, "cuDeviceGetPCIBusId");
  auto cuName = (Str)sym(cu, "cuDeviceGetName");
  auto nvInit = (NvVoid)sym(nv, "nvmlInit_v2");
  auto nvShutdown = (NvVoid)sym(nv, "nvmlShutdown");
  auto nvCount = (NvCount)sym(nv, "nvmlDeviceGetCount_v2");
  auto nvHandle = (NvHandle)sym(nv, "nvmlDeviceGetHandleByIndex_v2");
  auto nvMinor = (NvMinor)sym(nv, "nvmlDeviceGetMinorNumber");
  auto nvUuid = (NvUuid)sym(nv, "nvmlDeviceGetUUID");
  if (!err->empty()) return false;
  auto ok = [&](int rc, const char *call) {
    if (rc != 0) *err = std::string(call) + " failed: " + std::to_string(rc);
    return rc == 0;
  };
  if (!ok(cuInit(0), "cuInit")) return false;
  int n = 0;
  if (!ok(cuCount(&n), "cuDeviceGetCount")) return false;
  std::vector<DriverCard> devices;
  for (int ordinal = 0; ordinal < n; ordinal++) {
    int dev = 0;
    if (!ok(cuGet(&dev, ordinal), "cuDeviceGet")) return false;
    unsigned char raw[16];
    if (!ok(cuUuid(raw, dev), "cuDeviceGetUuid")) return false;
    char hex[33];
    for (int i = 0; i < 16; i++) snprintf(hex + 2 * i, 3, "%02x", raw[i]);
    std::string h(hex, 32);
    DriverCard c;
    c.minor = -1;
    c.uuid = "GPU-" + h.substr(0, 8) + "-" + h.substr(8, 4) + "-" +
             h.substr(12, 4) + "-" + h.substr(16, 4) + "-" + h.substr(20);
    char buf[256];
    if (!ok(cuBus(buf, 64, dev), "cuDeviceGetPCIBusId")) return false;
    c.bus = normalize_bus_id(buf);
    if (!ok(cuName(buf, 256, dev), "cuDeviceGetName")) return false;
    c.name = buf;
    devices.push_back(c);
  }
  if (!ok(nvInit(), "nvmlInit_v2")) return false;
  std::vector<DriverCard> named;  // NVML index order
  unsigned count = 0;
  bool good = ok(nvCount(&count), "nvmlDeviceGetCount_v2");
  for (unsigned i = 0; good && i < count; i++) {
    void *handle = nullptr;
    unsigned minor = 0;
    char uuid[96] = {0};
    good = ok(nvHandle(i, &handle), "nvmlDeviceGetHandleByIndex_v2") &&
           ok(nvMinor(handle, &minor), "nvmlDeviceGetMinorNumber") &&
           ok(nvUuid(handle, uuid, sizeof(uuid)), "nvmlDeviceGetUUID");
    if (good) {
      DriverCard c;
      c.minor = static_cast<int>(minor);
      c.uuid = uuid;
      named.push_back(c);
    }
  }
  nvShutdown();
  if (!good) return false;
  std::vector<std::string> a, b;
  for (const auto &c : named) a.push_back(c.uuid);
  for (const auto &d : devices) b.push_back(d.uuid);
  std::sort(a.begin(), a.end());
  std::sort(b.begin(), b.end());
  if (a != b) {
    *err = "NVML names " + std::to_string(named.size()) +
           " cards, the CUDA driver " + std::to_string(devices.size()) +
           ": not the same UUIDs";
    return false;
  }
  for (auto &c : named)
    for (const auto &d : devices)
      if (d.uuid == c.uuid) { c.bus = d.bus; c.name = d.name; }
  *cards = named;
  return true;
}

}  // namespace

extern "C" int tpu_discover(const char *host_root_c, const char *gens_spec,
                            const char *env_spec, char *out,
                            size_t out_len) {
  std::string root = host_root_c ? host_root_c : "/";
  while (root.size() > 1 && root.back() == '/') root.pop_back();
  if (root.empty()) root = "/";
  auto rooted = [&](const std::string &rel) {
    return (root == "/" ? "" : root) + "/" + rel;
  };

  // -- parse inputs --------------------------------------------------------
  std::vector<Generation> gens;
  for (const auto &line : split(gens_spec ? gens_spec : "", '\n')) {
    if (line.empty()) continue;
    auto f = split(line, '|');
    if (f.size() != 5) {
      snprintf(out, out_len, "bad generation line: %s", line.c_str());
      return -1;
    }
    Generation g;
    g.name = f[0]; g.product = f[1];
    g.cores = atoi(f[2].c_str());
    g.hbm = atoll(f[3].c_str());
    for (auto &id : split(f[4], ','))
      if (!id.empty()) g.pci_ids.push_back(lower(id));
    gens.push_back(g);
  }
  std::map<std::string, std::string> env;
  for (const auto &line : split(env_spec ? env_spec : "", '\n')) {
    auto eq = line.find('=');
    if (eq == std::string::npos) continue;
    env[line.substr(0, eq)] = line.substr(eq + 1);
  }
  auto getenv_s = [&](const char *k) -> std::string {
    auto it = env.find(k);
    return it == env.end() ? "" : it->second;
  };

  std::string hostname = getenv_s("HOSTNAME");
  if (hostname.empty()) {
    char buf[256] = {0};
    gethostname(buf, sizeof(buf) - 1);
    hostname = buf;
  }

  // -- slice membership (sysfs.py _slice_membership) -----------------------
  bool have_slice = false;
  std::string slice_id = getenv_s("TPU_SLICE_ID");
  if (slice_id.empty()) slice_id = getenv_s("MEGASCALE_SLICE_ID");
  std::string topo_s = getenv_s("TPU_TOPOLOGY");
  if (topo_s.empty()) topo_s = getenv_s("TPU_HOST_BOUNDS");
  Shape topology, host_bounds{2, 2, 1};
  int worker_id = 0, num_workers = 1;
  std::vector<std::string> worker_hostnames;
  std::string coordinator;
  std::string hb_env = getenv_s("TPU_CHIPS_PER_HOST_BOUNDS");
  if (!hb_env.empty() && !parse_bounds(hb_env, &host_bounds)) {
    snprintf(out, out_len, "bad TPU_CHIPS_PER_HOST_BOUNDS: %s",
             hb_env.c_str());
    return -1;
  }
  if (!topo_s.empty() && !slice_id.empty()) {
    if (!parse_shape(topo_s, &topology)) {
      snprintf(out, out_len, "bad TPU_TOPOLOGY: %s", topo_s.c_str());
      return -1;
    }
    have_slice = true;
    worker_id = atoi(getenv_s("TPU_WORKER_ID").c_str());
    for (auto &h : split(getenv_s("TPU_WORKER_HOSTNAMES"), ','))
      if (!h.empty()) worker_hostnames.push_back(h);
    num_workers = worker_hostnames.empty()
                      ? std::max(topology.n() / host_bounds.n(), 1)
                      : int(worker_hostnames.size());
    if (!worker_hostnames.empty()) coordinator = worker_hostnames[0];
  }
  int ox = 0, oy = 0, oz = 0;
  if (have_slice) host_origin(worker_id, host_bounds, topology, &ox, &oy, &oz);

  // -- chip enumeration (sysfs.py enumerate) -------------------------------
  struct Chip {
    int index; std::string uuid, gen; int cx, cy, cz;
    std::vector<std::string> dev_paths;
    std::string pci; int numa;
  };
  std::vector<Chip> chips;
  std::string accel_base = rooted("sys/class/accel");
  if (dir_exists(accel_base)) {
    std::vector<int> indices;
    for (const auto &name : list_dir(accel_base)) {
      int index;
      if (name.size() > 5 && accel_index(name, &index))
        indices.push_back(index);
    }
    std::sort(indices.begin(), indices.end());

    std::string decl = getenv_s("TPU_ACCELERATOR_TYPE");
    for (int index : indices) {
      std::string device_dir =
          accel_base + "/accel" + std::to_string(index) + "/device";
      std::string vendor = lower(read_file_trim(device_dir + "/vendor"));
      if (!vendor.empty() && vendor != kGooglePciVendor) continue;
      std::string dev_id = lower(read_file_trim(device_dir + "/device"));
      const Generation *gen = nullptr;
      for (const auto &g : gens)
        for (const auto &id : g.pci_ids)
          if (id == dev_id) { gen = &g; break; }
      if (!gen && !decl.empty()) {
        for (const auto &g : gens)
          if (starts_with(decl, g.name) || starts_with(decl, g.product)) {
            gen = &g;
            break;
          }
      }
      if (!gen) continue;

      char resolved[PATH_MAX];
      std::string pci;
      if (realpath(device_dir.c_str(), resolved)) {
        pci = resolved;
        auto slash = pci.find_last_of('/');
        if (slash != std::string::npos) pci = pci.substr(slash + 1);
      }
      std::string numa_s = read_file_trim(device_dir + "/numa_node");
      int numa = numa_s.empty() ? -1 : atoi(numa_s.c_str());
      std::string serial = read_file_trim(device_dir + "/serial_number");
      std::string uuid;
      if (!serial.empty()) {
        uuid = "TPU-" + gen->name + "-" + serial;
      } else {
        std::string key =
            hostname + "/" + pci + "/" + std::to_string(index);
        uuid = "TPU-" + gen->name + "-" + sha256_hex(key).substr(0, 16);
      }
      int lx = index % host_bounds.x;
      int ly = (index / host_bounds.x) % host_bounds.y;
      int lz = index / (host_bounds.x * host_bounds.y);
      Chip c;
      c.index = index; c.uuid = uuid; c.gen = gen->name;
      c.cx = ox + lx; c.cy = oy + ly; c.cz = oz + lz;
      c.dev_paths.push_back("/dev/accel" + std::to_string(index));
      if (file_exists(rooted("dev/vfio/" + std::to_string(index))))
        c.dev_paths.push_back("/dev/vfio/" + std::to_string(index));
      c.pci = pci; c.numa = numa;
      chips.push_back(c);
    }
  }

  // -- NVIDIA cards (sysfs.py _nvidia_cards) -------------------------------
  struct Card { int minor; std::string uuid, gen, pci; int numa; };
  std::vector<Card> cards;
  auto by_product = [&](const std::string &model) -> const Generation * {
    std::string want = product_name(model);
    for (const auto &g : gens)
      if (g.product == want) return &g;
    return nullptr;
  };
  std::string libcuda;
  for (const char *rel : kLibcudaSearch) {
    if (regular_file(rooted(rel))) {
      libcuda = rel;
      break;
    }
  }
  std::string pci_base = rooted("sys/bus/pci/devices");
  std::vector<std::string> pci = nvidia_pci(pci_base);
  if (!pci.empty()) {
    for (const auto &bus : pci) {
      std::map<std::string, std::string> info;
      if (!read_information(rooted("proc/driver/nvidia/gpus/" + bus +
                                   "/information"), &info))
        continue;
      std::string minor_s = info["Device Minor"];
      if (!all_digits(minor_s)) continue;
      int minor = atoi(minor_s.c_str());
      const Generation *gen = by_product(info["Model"]);
      if (!gen) continue;
      std::string uuid = info["GPU UUID"];
      if (!gpu_uuid(uuid)) {
        std::string key = hostname + "/" + bus + "/" + std::to_string(minor);
        uuid = "GPU-" + gen->name + "-" + sha256_hex(key).substr(0, 16);
      }
      std::string numa_s = read_file_trim(pci_base + "/" + bus + "/numa_node");
      int numa = numa_s.empty() ? -1 : atoi(numa_s.c_str());
      cards.push_back(Card{minor, uuid, gen->name, bus, numa});
    }
  } else if (file_exists(rooted("dev/nvidiactl")) && !libcuda.empty()) {
    std::string lib = rooted(libcuda);
    std::string nvml = lib.substr(0, lib.find_last_of('/')) +
                       "/libnvidia-ml.so.1";
    std::vector<DriverCard> found;
    std::string err;
    if (!driver_cards(lib, nvml, &found, &err)) {
      snprintf(out, out_len, "%s", err.c_str());
      return -1;
    }
    for (const auto &c : found) {
      const Generation *gen = by_product(c.name);
      if (gen) cards.push_back(Card{c.minor, c.uuid, gen->name, c.bus, -1});
    }
  }
  std::stable_sort(cards.begin(), cards.end(),
                   [](const Card &a, const Card &b) { return a.minor < b.minor; });
  if (!chips.empty() && !cards.empty()) {
    std::vector<int> accel, minors;
    for (const auto &c : chips) accel.push_back(c.index);
    for (const auto &c : cards) minors.push_back(c.minor);
    std::string msg = "host shows accel-class chips " + join_ints(accel) +
                      " and NVIDIA cards " + join_ints(minors) +
                      ": one host serves one kind";
    snprintf(out, out_len, "%s", msg.c_str());
    return -2;
  }
  if (!cards.empty()) {
    have_slice = false;
    for (size_t k = 0; k < cards.size(); k++) {
      const Card &n = cards[k];
      Chip c;
      c.index = n.minor; c.uuid = n.uuid; c.gen = n.gen;
      c.cx = static_cast<int>(k); c.cy = 0; c.cz = 0;
      c.dev_paths.push_back("/dev/nvidia" + std::to_string(n.minor));
      c.pci = n.pci; c.numa = n.numa;
      chips.push_back(c);
    }
  }

  // -- libtpu / libcuda (sysfs.py _libtpu_path) ----------------------------
  std::string libtpu = getenv_s("LIBTPU_INIT_PATH");
  if (libtpu.empty()) libtpu = getenv_s("TPU_LIBRARY_PATH");
  if (libtpu.empty() && !cards.empty()) {
    if (!libcuda.empty()) libtpu = "/" + libcuda;
  } else if (libtpu.empty()) {
    for (const char *rel : kLibtpuSearch) {
      if (file_exists(rooted(rel))) {
        libtpu = std::string("/") + rel;
        break;
      }
    }
  }

  // -- JSON out -------------------------------------------------------------
  std::ostringstream js;
  js << "{\"hostname\":\"" << json_escape(hostname) << "\","
     << "\"libtpu_path\":\"" << json_escape(libtpu) << "\",";
  if (have_slice) {
    js << "\"slice\":{\"slice_id\":\"" << json_escape(slice_id) << "\","
       << "\"topology\":[" << topology.x << "," << topology.y << ","
       << topology.z << "],"
       << "\"worker_id\":" << worker_id << ","
       << "\"num_workers\":" << num_workers << ","
       << "\"host_bounds\":[" << host_bounds.x << "," << host_bounds.y
       << "," << host_bounds.z << "],"
       << "\"coordinator_address\":\"" << json_escape(coordinator)
       << "\"},";
  } else {
    js << "\"slice\":null,";
  }
  js << "\"chips\":[";
  for (size_t i = 0; i < chips.size(); i++) {
    const Chip &c = chips[i];
    if (i) js << ",";
    js << "{\"index\":" << c.index << ",\"uuid\":\"" << json_escape(c.uuid)
       << "\",\"generation\":\"" << json_escape(c.gen) << "\","
       << "\"coord\":[" << c.cx << "," << c.cy << "," << c.cz << "],"
       << "\"dev_paths\":[";
    for (size_t j = 0; j < c.dev_paths.size(); j++) {
      if (j) js << ",";
      js << "\"" << json_escape(c.dev_paths[j]) << "\"";
    }
    js << "],\"pci_address\":\"" << json_escape(c.pci) << "\","
       << "\"numa_node\":" << c.numa << "}";
  }
  js << "]}";

  std::string result = js.str();
  if (result.size() + 1 > out_len)
    return static_cast<int>(result.size() + 1);
  memcpy(out, result.c_str(), result.size() + 1);
  return static_cast<int>(result.size() + 1);
}

extern "C" const char *tpu_discover_version() { return "tpudiscovery/0.1.0"; }
