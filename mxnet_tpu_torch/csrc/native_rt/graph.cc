// The symbol-JSON interpreter: the graph of a program section, its attrs
// parsed as ops/registry.py parses them, and a run over the nodes in the
// JSON's topological order (executor.py's build_graph_fn).
#include <cstdlib>
#include <cstring>

#include "runtime.h"

namespace mxt_rt {

// ---- attrs ----------------------------------------------------------------
bool Attrs::has(const std::string& k) const {
  return m && m->count(k);
}

std::string Attrs::str(const std::string& k, const std::string& def) const {
  if (!has(k)) return def;
  return m->at(k);
}

double Attrs::f(const std::string& k, double def) const {
  if (!has(k)) return def;
  const std::string& s = m->at(k);
  char* end = nullptr;
  double v = strtod(s.c_str(), &end);
  if (end == s.c_str())
    throw RtError("op " + op + ": cannot parse attr " + k + "=" + s);
  return v;
}

int64_t Attrs::i(const std::string& k, int64_t def) const {
  if (!has(k)) return def;
  return static_cast<int64_t>(f(k, 0.0));  // int(float(v))
}

int64_t Attrs::required_i(const std::string& k) const {
  if (!has(k)) throw RtError("op " + op + ": required attr '" + k + "' missing");
  return i(k, 0);
}

bool Attrs::b(const std::string& k, bool def) const {
  if (!has(k)) return def;
  std::string s;
  for (char c : m->at(k))
    if (!isspace(static_cast<unsigned char>(c))) s += tolower(c);
  return s == "true" || s == "1" || s == "yes";
}

std::optional<std::vector<int64_t>> Attrs::shape(const std::string& k) const {
  if (!has(k)) return std::nullopt;
  std::string s = m->at(k);
  size_t a = s.find_first_not_of(" \t");
  size_t z = s.find_last_not_of(" \t");
  s = a == std::string::npos ? "" : s.substr(a, z - a + 1);
  if (s == "None" || s.empty()) return std::nullopt;
  std::vector<int64_t> out;
  std::string tok;
  auto flush = [&]() {
    size_t p = tok.find_first_not_of(" \t");
    if (p != std::string::npos) {
      char* end = nullptr;
      double v = strtod(tok.c_str(), &end);
      if (end == tok.c_str())
        throw RtError("op " + op + ": cannot parse attr " + k + "=" + m->at(k));
      out.push_back(static_cast<int64_t>(v));
    }
    tok.clear();
  };
  for (char c : s) {
    if (c == '(' || c == ')' || c == '[' || c == ']') continue;
    if (c == ',') flush();
    else tok += c;
  }
  flush();
  return out;
}

// ---- parsing ------------------------------------------------------------------
// the program's "dp" entry (absent in a one-position program): a form per
// node and a batch axis (null: none; "unknown") per node output
static bool parse_dp_plan(const JVal* dp, Graph* g, std::string* err) {
  if (!dp) return true;
  const JVal* n = dp->get("num_devices");
  const JVal* forms = dp->get("forms");
  const JVal* axes = dp->get("batch_axes");
  const size_t nodes = g->nodes.size();
  if (!n || n->kind != JVal::NUM || n->num < 1 || !forms || !axes ||
      forms->kind != JVal::ARR || axes->kind != JVal::ARR ||
      forms->arr.size() != nodes || axes->arr.size() != nodes) {
    *err = ".mxa: the program's data-parallel plan is malformed";
    return false;
  }
  g->dp.n = static_cast<int>(n->num);
  for (size_t i = 0; i < nodes; ++i) {
    const JVal& f = forms->arr[i];
    const JVal& a = axes->arr[i];
    if ((f.kind != JVal::STR && f.kind != JVal::NUL) || a.kind != JVal::ARR) {
      *err = ".mxa: the data-parallel plan of node '" + g->nodes[i].name +
             "' is malformed";
      return false;
    }
    g->dp.forms.push_back(f.kind == JVal::STR ? f.str : "");
    std::vector<int> out;
    for (const auto& x : a.arr)
      out.push_back(x.kind == JVal::NUM ? static_cast<int>(x.num)
                    : x.kind == JVal::NUL ? kNoBatch
                                          : kUnknownAxis);
    g->dp.axes.push_back(std::move(out));
  }
  return true;
}

bool parse_graph(const std::string& json, Graph* g, std::string* err) {
  JVal j;
  if (!json_parse(json.data(), json.size(), &j) || j.kind != JVal::OBJ) {
    *err = ".mxa: the program is not valid symbol JSON";
    return false;
  }
  const JVal* nodes = j.get("nodes");
  const JVal* heads = j.get("heads");
  if (!nodes || !heads || nodes->kind != JVal::ARR || heads->kind != JVal::ARR) {
    *err = ".mxa: the program has no nodes/heads";
    return false;
  }
  auto entry = [&](const JVal& e, size_t limit, std::pair<int, int>* out) {
    if (e.kind != JVal::ARR || e.arr.size() < 2) return false;
    int nid = static_cast<int>(e.arr[0].num);
    int idx = static_cast<int>(e.arr[1].num);
    if (nid < 0 || static_cast<size_t>(nid) >= limit || idx < 0) return false;
    *out = {nid, idx};
    return true;
  };
  for (size_t i = 0; i < nodes->arr.size(); ++i) {
    const JVal& jn = nodes->arr[i];
    const JVal* op = jn.get("op");
    const JVal* name = jn.get("name");
    const JVal* inputs = jn.get("inputs");
    if (!op || !name || op->kind != JVal::STR || name->kind != JVal::STR) {
      *err = ".mxa: program node " + std::to_string(i) + " has no op/name";
      return false;
    }
    Node n;
    n.op = op->str;
    n.name = name->str;
    const JVal* attrs = jn.get("attrs");
    if (!attrs) attrs = jn.get("param");
    if (attrs && attrs->kind == JVal::OBJ)
      for (const auto& kv : attrs->obj)
        if (kv.second.kind == JVal::STR) n.attrs[kv.first] = kv.second.str;
    if (inputs && inputs->kind == JVal::ARR)
      for (const auto& e : inputs->arr) {
        std::pair<int, int> in;
        if (!entry(e, i, &in)) {  // inputs come earlier: topological order
          *err = ".mxa: program node '" + n.name + "' has a bad input";
          return false;
        }
        n.inputs.push_back(in);
      }
    g->nodes.push_back(std::move(n));
  }
  for (const auto& e : heads->arr) {
    std::pair<int, int> h;
    if (!entry(e, g->nodes.size(), &h)) {
      *err = ".mxa: the program has a bad head";
      return false;
    }
    g->heads.push_back(h);
  }
  return parse_dp_plan(j.get("dp"), g, err);
}

// ---- running ----------------------------------------------------------------------
std::vector<std::vector<std::vector<at::Tensor>>> run_graph(
    const Graph& g, std::vector<std::map<std::string, at::Tensor>>* vars,
    const std::vector<OpCtx>& ctxs,
    const std::vector<std::pair<int, int>>& keep) {
  const size_t n = g.nodes.size();
  const size_t P = ctxs.size();
  // last reader of each node: its outputs are dropped after it ran
  std::vector<size_t> last(n, 0);
  std::vector<char> pinned(n, 0);
  for (size_t i = 0; i < n; ++i)
    for (const auto& in : g.nodes[i].inputs) last[in.first] = i;
  for (const auto& h : g.heads) pinned[h.first] = 1;
  for (const auto& k : keep) pinned[k.first] = 1;

  // vals[i][p]: node i's outputs at position p
  std::vector<std::vector<std::vector<at::Tensor>>> vals(
      n, std::vector<std::vector<at::Tensor>>(P));
  for (size_t i = 0; i < n; ++i) {
    const Node& node = g.nodes[i];
    if (node.op == "null") {
      for (size_t p = 0; p < P; ++p) {
        auto it = (*vars)[p].find(node.name);
        if (it == (*vars)[p].end())
          throw RtError("program variable '" + node.name +
                        "' has no value in the artifact");
        vals[i][p] = {it->second};
      }
      continue;
    }
    std::vector<std::vector<at::Tensor>> in(P);
    for (size_t p = 0; p < P; ++p) {
      in[p].reserve(node.inputs.size());
      for (const auto& e : node.inputs) {
        const auto& src = vals[e.first][p];
        if (static_cast<size_t>(e.second) >= src.size())
          throw RtError("op " + node.name + ": input from '" +
                        g.nodes[e.first].name + "' output " +
                        std::to_string(e.second) + " does not exist");
        in[p].push_back(src[e.second]);
      }
    }
    std::vector<OpOut> out = run_node(g, static_cast<int>(i), in, ctxs);
    for (size_t p = 0; p < P; ++p) {
      vals[i][p] = std::move(out[p].outputs);
      for (auto& na : out[p].new_aux) {
        const auto& src = node.inputs.at(na.first);
        const Node& var = g.nodes[src.first];
        if (var.op != "null")
          throw RtError("op " + node.name + ": an auxiliary state that is "
                        "not a variable");
        (*vars)[p][var.name] = na.second;
      }
    }
    for (const auto& e : node.inputs)
      if (last[e.first] == i && !pinned[e.first] &&
          g.nodes[e.first].op != "null")
        for (auto& v : vals[e.first]) v.clear();
  }
  return vals;
}

// ---- devices and dtypes -----------------------------------------------------------
bool resolve_device(int dev_type, int dev_id, at::Device* out,
                    std::string* err) {
  // float32 products in full float32, as the port sets at its import
  // (TF32 off for cuBLAS and cuDNN): the same values as its executor
  at::globalContext().setAllowTF32CuBLAS(false);
  at::globalContext().setAllowTF32CuDNN(false);
  if (dev_type == 1) {
    *out = at::Device(at::kCPU);
    return true;
  }
  if (dev_type != 2) {
    const char* ctx = getenv("MXNET_DEFAULT_CONTEXT");
    if (ctx && strcmp(ctx, "cpu") == 0) {
      *out = at::Device(at::kCPU);
      return true;
    }
  }
  if (!at::hasCUDA()) {
    *err = "no CUDA device: the port's runtime runs on the card unless the "
           "caller asks for the CPU (dev_type 1, or MXNET_DEFAULT_CONTEXT=cpu)";
    return false;
  }
  *out = at::Device(at::kCUDA, static_cast<c10::DeviceIndex>(
                                   dev_type == 2 ? dev_id : 0));
  return true;
}

at::ScalarType dtype_by_name(const std::string& name, bool* ok) {
  *ok = true;
  if (name == "float32") return at::kFloat;
  if (name == "float64") return at::kDouble;
  if (name == "float16") return at::kHalf;
  if (name == "bfloat16") return at::kBFloat16;
  if (name == "uint8") return at::kByte;
  if (name == "int32") return at::kInt;
  if (name == "int8") return at::kChar;
  if (name == "int64") return at::kLong;
  if (name == "bool") return at::kBool;
  *ok = false;
  return at::kFloat;
}

at::ScalarType dtype_by_flag(int flag, bool* ok) {
  static const at::ScalarType table[] = {
      at::kFloat, at::kDouble, at::kHalf, at::kByte, at::kInt,
      at::kChar,  at::kLong,   at::kBFloat16, at::kBool};
  *ok = flag >= 0 && flag < 9;
  return *ok ? table[flag] : at::kFloat;
}

}  // namespace mxt_rt
