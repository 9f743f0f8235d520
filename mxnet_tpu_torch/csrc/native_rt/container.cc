// The .mxa container reader, its JSON reader (a copy of the JAX package's
// in mxnet_tpu/src/c_predict_pjrt.cc: the port compiles nothing from
// mxnet_tpu/) and the .params wire, with and without nd.save's CRC footer.
#include "container.h"

#include <cctype>
#include <cstdio>
#include <cstdlib>
#include <cstring>

namespace mxt_rt {

namespace {
thread_local std::string g_err;

constexpr uint32_t kNDArrayMagic = 0xF993FAC8u;
constexpr uint64_t kListMagic = 0x112;
constexpr int kDTypeSize[] = {4, 8, 2, 1, 4, 1, 8, 2, 1};
}  // namespace

int fail(const std::string& msg) {
  g_err = msg;
  return -1;
}

const char* last_error() { return g_err.c_str(); }

int wire_dtype_size(int flag) {
  if (flag < 0 || flag >= static_cast<int>(sizeof kDTypeSize / sizeof(int)))
    return 0;
  return kDTypeSize[flag];
}

// ---- JSON -------------------------------------------------------------------
namespace {

struct JParser {
  const char* p;
  const char* end;
  bool ok = true;
  int depth = 0;

  void ws() {
    while (p < end && (*p == ' ' || *p == '\t' || *p == '\n' || *p == '\r'))
      ++p;
  }
  bool lit(const char* s) {
    size_t n = strlen(s);
    if (static_cast<size_t>(end - p) < n || strncmp(p, s, n) != 0) return false;
    p += n;
    return true;
  }
  JVal parse() {
    ws();
    JVal v;
    if (p >= end || ++depth > 256) { ok = false; return v; }
    switch (*p) {
      case '{': {
        v.kind = JVal::OBJ;
        ++p; ws();
        if (p < end && *p == '}') { ++p; break; }
        while (ok) {
          ws();
          if (p >= end || *p != '"') { ok = false; break; }
          std::string key = pstr();
          ws();
          if (p >= end || *p++ != ':') { ok = false; break; }
          v.obj[key] = parse();
          ws();
          if (p < end && *p == ',') { ++p; continue; }
          if (p < end && *p == '}') { ++p; break; }
          ok = false;
        }
        break;
      }
      case '[': {
        v.kind = JVal::ARR;
        ++p; ws();
        if (p < end && *p == ']') { ++p; break; }
        while (ok) {
          v.arr.push_back(parse());
          ws();
          if (p < end && *p == ',') { ++p; continue; }
          if (p < end && *p == ']') { ++p; break; }
          ok = false;
        }
        break;
      }
      case '"':
        v.kind = JVal::STR;
        v.str = pstr();
        break;
      case 't': v.kind = JVal::BOOL; v.b = true; ok = ok && lit("true"); break;
      case 'f': v.kind = JVal::BOOL; v.b = false; ok = ok && lit("false"); break;
      case 'n': v.kind = JVal::NUL; ok = ok && lit("null"); break;
      default: {
        v.kind = JVal::NUM;
        // bound the scan: the buffer is a slice of the artifact, not
        // NUL-terminated
        std::string numbuf;
        const char* q = p;
        while (q < end && (isdigit(static_cast<unsigned char>(*q)) ||
                           *q == '-' || *q == '+' || *q == '.' ||
                           *q == 'e' || *q == 'E'))
          numbuf += *q++;
        char* parsed_end = nullptr;
        v.num = strtod(numbuf.c_str(), &parsed_end);
        if (numbuf.empty() || parsed_end == numbuf.c_str()) {
          ok = false;
          break;
        }
        p += parsed_end - numbuf.c_str();
        break;
      }
    }
    --depth;
    return v;
  }
  std::string pstr() {
    std::string s;
    if (p >= end || *p != '"') { ok = false; return s; }
    ++p;
    while (p < end && *p != '"') {
      if (*p == '\\' && p + 1 < end) {
        ++p;
        switch (*p) {
          case 'n': s += '\n'; break;
          case 't': s += '\t'; break;
          case 'r': s += '\r'; break;
          case 'b': s += '\b'; break;
          case 'f': s += '\f'; break;
          case 'u': {
            if (end - p < 5) { ok = false; return s; }
            unsigned cp = 0;
            for (int i = 1; i <= 4; ++i) {
              char c = p[i];
              cp <<= 4;
              if (c >= '0' && c <= '9') cp |= c - '0';
              else if (c >= 'a' && c <= 'f') cp |= c - 'a' + 10;
              else if (c >= 'A' && c <= 'F') cp |= c - 'A' + 10;
              else { ok = false; return s; }
            }
            p += 4;
            if (cp < 0x80) {
              s += static_cast<char>(cp);
            } else if (cp < 0x800) {
              s += static_cast<char>(0xC0 | (cp >> 6));
              s += static_cast<char>(0x80 | (cp & 0x3F));
            } else {
              s += static_cast<char>(0xE0 | (cp >> 12));
              s += static_cast<char>(0x80 | ((cp >> 6) & 0x3F));
              s += static_cast<char>(0x80 | (cp & 0x3F));
            }
            break;
          }
          default: s += *p;
        }
      } else {
        s += *p;
      }
      ++p;
    }
    if (p >= end) { ok = false; return s; }
    ++p;  // closing quote
    return s;
  }
};

struct Cursor {
  const char* p;
  const char* end;
  bool read(void* dst, size_t n) {
    if (static_cast<size_t>(end - p) < n) return false;
    memcpy(dst, p, n);
    p += n;
    return true;
  }
};

}  // namespace

bool json_parse(const char* data, size_t n, JVal* out) {
  JParser jp{data, data + n};
  *out = jp.parse();
  jp.ws();
  return jp.ok;
}

// ---- .params ------------------------------------------------------------------
bool parse_params(const char* data, size_t n, std::vector<HostArray>* out,
                  std::string* err) {
  Cursor c{data, data + n};
  uint64_t magic = 0, reserved = 0, count = 0;
  if (!c.read(&magic, 8) || magic != kListMagic) {
    *err = "params blob: bad list magic";
    return false;
  }
  if (!c.read(&reserved, 8) || !c.read(&count, 8)) {
    *err = "params blob: truncated header";
    return false;
  }
  if (count > (1u << 24)) {
    *err = "params blob: implausible array count";
    return false;
  }
  out->assign(count, HostArray());
  for (uint64_t i = 0; i < count; ++i) {
    HostArray& a = (*out)[i];
    uint32_t m = 0, ndim = 0;
    if (!c.read(&m, 4)) { *err = "params blob: truncated record"; return false; }
    if (m == kNDArrayMagic) {
      if (!c.read(&ndim, 4)) { *err = "params blob: truncated record"; return false; }
    } else {
      ndim = m;  // legacy pre-V1 layout: the first word is ndim
    }
    if (ndim > 64) { *err = "params blob: implausible ndim"; return false; }
    size_t elems = 1;
    for (uint32_t d = 0; d < ndim; ++d) {
      uint32_t s = 0;
      if (!c.read(&s, 4)) { *err = "params blob: truncated shape"; return false; }
      if (s > (1u << 31)) { *err = "params blob: implausible shape"; return false; }
      if (s != 0 && elems > (size_t(1) << 40) / s) {
        *err = "params blob: implausible size";
        return false;
      }
      elems *= s;
      a.shape.push_back(s);
      a.shape_u32.push_back(s);
    }
    if (ndim == 0) {  // the "none" record stops after its shape
      a.none = true;
      continue;
    }
    int32_t devctx[2];
    int32_t flag = 0;
    if (!c.read(devctx, 8) || !c.read(&flag, 4)) {
      *err = "params blob: truncated header";
      return false;
    }
    int size = wire_dtype_size(flag);
    if (size == 0) { *err = "params blob: unknown dtype flag"; return false; }
    a.dtype = flag;
    a.data.resize(elems * size);
    if (!c.read(a.data.data(), a.data.size())) {
      *err = "params blob: truncated data";
      return false;
    }
  }
  uint64_t n_names = 0;
  if (c.read(&n_names, 8) && n_names == count) {
    for (uint64_t i = 0; i < n_names; ++i) {
      uint64_t len = 0;
      if (!c.read(&len, 8) || len > (1u << 20)) {
        *err = "params blob: bad name";
        return false;
      }
      std::string s(len, '\0');
      if (!c.read(&s[0], len)) { *err = "params blob: truncated name"; return false; }
      (*out)[i].name = s;
    }
  }
  // what follows the names is nd.save's CRC footer or nothing
  return true;
}

bool write_params_f32(const std::string& path,
                      const std::vector<std::string>& names,
                      const std::vector<std::vector<int64_t>>& shapes,
                      const std::vector<const float*>& data,
                      std::string* err) {
  FILE* f = fopen(path.c_str(), "wb");
  if (!f) { *err = "cannot open for write: " + path; return false; }
  auto wr = [&](const void* p, size_t n) { return fwrite(p, 1, n, f) == n; };
  bool ok = true;
  uint64_t magic = kListMagic, reserved = 0, count = names.size();
  ok = ok && wr(&magic, 8) && wr(&reserved, 8) && wr(&count, 8);
  for (size_t i = 0; ok && i < names.size(); ++i) {
    // ndim 0 is the "none" record to every reader: a scalar goes as (1,)
    std::vector<uint32_t> dims(shapes[i].begin(), shapes[i].end());
    if (dims.empty()) dims.push_back(1);
    uint32_t nd_magic = kNDArrayMagic, ndim = static_cast<uint32_t>(dims.size());
    size_t elems = 1;
    for (uint32_t d : dims) elems *= d;
    int32_t devctx[2] = {1, 0};  // cpu(0)
    int32_t flag = kF32;
    ok = ok && wr(&nd_magic, 4) && wr(&ndim, 4) &&
         wr(dims.data(), 4 * dims.size()) && wr(devctx, 8) && wr(&flag, 4) &&
         wr(data[i], elems * sizeof(float));
  }
  uint64_t n_names = names.size();
  ok = ok && wr(&n_names, 8);
  for (size_t i = 0; ok && i < names.size(); ++i) {
    uint64_t len = names[i].size();
    ok = ok && wr(&len, 8) && wr(names[i].data(), len);
  }
  ok = (fclose(f) == 0) && ok;  // flush failures (a full disk) land here
  if (!ok) { *err = "short write: " + path; return false; }
  return true;
}

// ---- the container ------------------------------------------------------------
bool read_artifact(const char* bytes, size_t size, Artifact* out,
                   std::string* err) {
  if (size < 16 || memcmp(bytes, "MXTPUAR1", 8) != 0) {
    *err = "not an .mxa artifact (bad magic); build one with "
           "mxnet_tpu_torch.export_predict_artifact or export_train_artifact";
    return false;
  }
  Cursor c{bytes + 8, bytes + size};
  uint64_t mlen = 0;
  if (!c.read(&mlen, 8) || static_cast<uint64_t>(c.end - c.p) < mlen) {
    *err = ".mxa: truncated manifest";
    return false;
  }
  if (!json_parse(c.p, mlen, &out->manifest) ||
      out->manifest.kind != JVal::OBJ) {
    *err = ".mxa: manifest is not valid JSON";
    return false;
  }
  c.p += mlen;
  uint64_t plen = 0;
  if (!c.read(&plen, 8) || static_cast<uint64_t>(c.end - c.p) < plen) {
    *err = ".mxa: truncated program";
    return false;
  }
  out->program.assign(c.p, plen);
  c.p += plen;
  const JVal* fmt = out->manifest.get("program_format");
  bool mlir = plen >= 4 && memcmp(out->program.data(), "ML\xef" "R", 4) == 0;
  if (mlir || !fmt || fmt->kind != JVal::STR ||
      fmt->str != "mxnet-symbol-json") {
    *err = std::string(".mxa: ") +
           (mlir ? "the program is StableHLO bytecode"
                 : "the manifest names no program_format") +
           ": a JAX package artifact, which the port's runtime does not run "
           "(ROADMAP.md C34: the port's program section is symbol JSON; "
           "re-export with mxnet_tpu_torch.export_predict_artifact or "
           "export_train_artifact; the params section loads in both)";
    return false;
  }
  uint64_t qlen = 0;
  if (!c.read(&qlen, 8) || static_cast<uint64_t>(c.end - c.p) < qlen) {
    *err = ".mxa: truncated params";
    return false;
  }
  std::string perr;
  if (!parse_params(c.p, qlen, &out->params, &perr)) {
    *err = ".mxa: " + perr;
    return false;
  }
  out->by_name.clear();
  for (const auto& a : out->params) out->by_name[a.name] = &a;
  return true;
}

bool read_file(const std::string& path, std::vector<char>* out,
               std::string* err) {
  FILE* f = fopen(path.c_str(), "rb");
  if (!f) { *err = "cannot open " + path; return false; }
  fseek(f, 0, SEEK_END);
  long sz = ftell(f);
  fseek(f, 0, SEEK_SET);
  if (sz <= 0) {  // a FIFO or an empty file
    fclose(f);
    *err = "cannot size " + path + " (need a regular file)";
    return false;
  }
  out->resize(sz);
  size_t got = fread(out->data(), 1, sz, f);
  fclose(f);
  if (got != static_cast<size_t>(sz)) { *err = "short read on " + path; return false; }
  return true;
}

bool json_shape(const JVal& j, std::vector<int64_t>* shape,
                std::vector<uint32_t>* shape_u32, int64_t* n_elem) {
  if (j.kind != JVal::ARR || j.arr.size() > 64) return false;
  *n_elem = 1;
  for (const auto& d : j.arr) {
    int64_t v = static_cast<int64_t>(d.num);
    if (d.kind != JVal::NUM || v < 0 || v > (int64_t{1} << 31)) return false;
    // divide before multiplying: the product itself could overflow
    if (v != 0 && *n_elem > (int64_t{1} << 40) / v) return false;
    shape->push_back(v);
    shape_u32->push_back(static_cast<uint32_t>(v));
    *n_elem *= v;
  }
  return true;
}

}  // namespace mxt_rt
