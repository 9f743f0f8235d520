// The .mxa container, its JSON manifest and its .params section, read
// with no Python and no libtorch (the parts of the runtime the C API's
// error paths need before a tensor exists).
//
// Container layout (little-endian; export_artifact.py writes it):
//   8 bytes "MXTPUAR1" | u64 n, manifest JSON | u64 n, program | u64 n,
//   params (NDArray-dict save format: u64 0x112, u64 reserved, u64 count,
//   records..., u64 n_names, names..., then nd.save's optional CRC footer).
// The port's program is symbol JSON ("program_format": "mxnet-symbol-json");
// the JAX package's is StableHLO bytecode, which this runtime refuses
// (ROADMAP.md C34).
#ifndef MXT_NATIVE_RT_CONTAINER_H_
#define MXT_NATIVE_RT_CONTAINER_H_

#include <cstddef>
#include <cstdint>
#include <map>
#include <string>
#include <vector>

namespace mxt_rt {

// ---- errors: every C entry point returns -1 with this text -------------
int fail(const std::string& msg);
const char* last_error();

// ---- JSON ---------------------------------------------------------------
struct JVal {
  enum Kind { OBJ, ARR, STR, NUM, BOOL, NUL } kind = NUL;
  std::map<std::string, JVal> obj;
  std::vector<JVal> arr;
  std::string str;
  double num = 0;
  bool b = false;

  const JVal* get(const std::string& k) const {
    auto it = obj.find(k);
    return it == obj.end() ? nullptr : &it->second;
  }
};

bool json_parse(const char* data, size_t n, JVal* out);

// ---- .params records -------------------------------------------------------
// dtype flags of the wire (reference mshadow flags 0..6, extensions 7..8)
enum WireDType { kF32 = 0, kF64 = 1, kF16 = 2, kU8 = 3, kI32 = 4, kI8 = 5,
                 kI64 = 6, kBF16 = 7, kBool = 8 };
int wire_dtype_size(int flag);  // 0 for an unknown flag

struct HostArray {
  std::string name;
  bool none = false;
  int dtype = 0;
  std::vector<int64_t> shape;
  std::vector<uint32_t> shape_u32;
  std::vector<uint8_t> data;
};

bool parse_params(const char* data, size_t n, std::vector<HostArray>* out,
                  std::string* err);

// writes a dict of float32 arrays in the same wire (no CRC footer, as the
// JAX package's native writer; ROADMAP.md C24)
bool write_params_f32(const std::string& path,
                      const std::vector<std::string>& names,
                      const std::vector<std::vector<int64_t>>& shapes,
                      const std::vector<const float*>& data,
                      std::string* err);

// ---- the container ----------------------------------------------------------
struct Artifact {
  JVal manifest;
  std::string program;
  std::vector<HostArray> params;
  std::map<std::string, const HostArray*> by_name;
};

// Parses the three sections and checks the program is the port's
// (symbol JSON); false with `err` set otherwise.
bool read_artifact(const char* bytes, size_t size, Artifact* out,
                   std::string* err);
bool read_file(const std::string& path, std::vector<char>* out,
               std::string* err);

// shape of a manifest row, bounded as the wire bounds a record
bool json_shape(const JVal& j, std::vector<int64_t>* shape,
                std::vector<uint32_t>* shape_u32, int64_t* n_elem);

}  // namespace mxt_rt

#endif  // MXT_NATIVE_RT_CONTAINER_H_
