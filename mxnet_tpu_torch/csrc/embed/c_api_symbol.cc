// Symbol C API over the framework's JSON graph format
// (ref: include/mxnet/c_api.h MXSymbol* block; the graph JSON is what
// mxnet_tpu_torch/symbol.py tojson() writes and sym.load reads, byte for
// byte the JAX package's).
//
// Pure C++ — no Python embedding: a deployment process can load, inspect
// and re-serialize model graphs with only this .so. The JSON subset
// parsed here is the machine-generated symbol format: one object with
// "nodes" (array of {op, name, attrs, inputs}) and "heads".
//
// Build: g++ at first use by mxnet_tpu_torch/_capi.py into the build
// directory (libmxtpu_torch_symbol-<hash>.so).
#include <array>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <fstream>
#include <map>
#include <memory>
#include <sstream>
#include <string>
#include <vector>

namespace {

thread_local std::string g_last_error;

struct Node {
  std::string op;      // "null" => variable
  std::string name;
  std::map<std::string, std::string> attrs;
  std::vector<std::array<int64_t, 3>> inputs;
};

struct Symbol {
  std::vector<Node> nodes;
  std::vector<std::array<int64_t, 3>> heads;
  std::string json;  // canonical serialization cache
  // storage backing the const char** views handed to callers
  std::vector<std::string> str_store;
  std::vector<const char*> ptr_store;
};

// ---------------------------------------------------------------------------
// minimal JSON parser for the constrained, machine-generated format
// ---------------------------------------------------------------------------

struct Parser {
  const char* p;
  const char* end;
  bool ok = true;
  std::string err;

  explicit Parser(const std::string& s) : p(s.data()), end(s.data() + s.size()) {}

  void fail(const std::string& m) {
    if (ok) {
      ok = false;
      err = m;
    }
  }

  void skip_ws() {
    while (p < end && (*p == ' ' || *p == '\n' || *p == '\t' || *p == '\r'))
      ++p;
  }

  bool consume(char c) {
    skip_ws();
    if (p < end && *p == c) {
      ++p;
      return true;
    }
    fail(std::string("expected '") + c + "'");
    return false;
  }

  bool peek(char c) {
    skip_ws();
    return p < end && *p == c;
  }

  uint32_t parse_hex4() {
    uint32_t v = 0;
    for (int i = 0; i < 4; ++i) {
      if (p >= end) { fail("truncated \\u escape"); return 0; }
      char c = *p++;
      v <<= 4;
      if (c >= '0' && c <= '9') v |= c - '0';
      else if (c >= 'a' && c <= 'f') v |= c - 'a' + 10;
      else if (c >= 'A' && c <= 'F') v |= c - 'A' + 10;
      else { fail("bad \\u escape"); return 0; }
    }
    return v;
  }

  void append_utf8(std::string* out, uint32_t cp) {
    if (cp < 0x80) {
      *out += static_cast<char>(cp);
    } else if (cp < 0x800) {
      *out += static_cast<char>(0xC0 | (cp >> 6));
      *out += static_cast<char>(0x80 | (cp & 0x3F));
    } else if (cp < 0x10000) {
      *out += static_cast<char>(0xE0 | (cp >> 12));
      *out += static_cast<char>(0x80 | ((cp >> 6) & 0x3F));
      *out += static_cast<char>(0x80 | (cp & 0x3F));
    } else {
      *out += static_cast<char>(0xF0 | (cp >> 18));
      *out += static_cast<char>(0x80 | ((cp >> 12) & 0x3F));
      *out += static_cast<char>(0x80 | ((cp >> 6) & 0x3F));
      *out += static_cast<char>(0x80 | (cp & 0x3F));
    }
  }

  std::string parse_string() {
    skip_ws();
    std::string out;
    if (p >= end || *p != '"') {
      fail("expected string");
      return out;
    }
    ++p;
    while (p < end && *p != '"') {
      if (*p == '\\' && p + 1 < end) {
        ++p;
        switch (*p) {
          case 'n': out += '\n'; ++p; break;
          case 't': out += '\t'; ++p; break;
          case 'r': out += '\r'; ++p; break;
          case 'b': out += '\b'; ++p; break;
          case 'f': out += '\f'; ++p; break;
          case '"': out += '"'; ++p; break;
          case '\\': out += '\\'; ++p; break;
          case '/': out += '/'; ++p; break;
          case 'u': {
            // json.dumps ensure_ascii emits \uXXXX for any non-ASCII
            // char, so full decoding (incl. surrogate pairs) is required
            ++p;
            uint32_t cp = parse_hex4();
            if (ok && cp >= 0xD800 && cp <= 0xDBFF && p + 1 < end &&
                p[0] == '\\' && p[1] == 'u') {
              p += 2;
              uint32_t lo = parse_hex4();
              if (ok && lo >= 0xDC00 && lo <= 0xDFFF)
                cp = 0x10000 + ((cp - 0xD800) << 10) + (lo - 0xDC00);
              else
                fail("unpaired surrogate in \\u escape");
            }
            if (ok) append_utf8(&out, cp);
            break;
          }
          default:
            fail("unknown escape");
            ++p;
        }
      } else {
        out += *p;
        ++p;
      }
    }
    if (p >= end) {
      fail("unterminated string");
      return out;
    }
    ++p;
    return out;
  }

  double parse_number() {
    skip_ws();
    char* q = nullptr;
    double v = std::strtod(p, &q);
    if (q == p) fail("expected number");
    p = q;
    return v;
  }

  void skip_value();  // fwd

  void skip_object() {
    consume('{');
    if (peek('}')) { ++p; return; }
    while (ok) {
      parse_string();
      consume(':');
      skip_value();
      skip_ws();
      if (peek(',')) { ++p; continue; }
      consume('}');
      break;
    }
  }

  void skip_array() {
    consume('[');
    if (peek(']')) { ++p; return; }
    while (ok) {
      skip_value();
      if (peek(',')) { ++p; continue; }
      consume(']');
      break;
    }
  }
};

void Parser::skip_value() {
  skip_ws();
  if (p >= end) { fail("eof"); return; }
  if (*p == '"') { parse_string(); return; }
  if (*p == '{') { skip_object(); return; }
  if (*p == '[') { skip_array(); return; }
  if (!std::strncmp(p, "true", 4)) { p += 4; return; }
  if (!std::strncmp(p, "false", 5)) { p += 5; return; }
  if (!std::strncmp(p, "null", 4)) { p += 4; return; }
  parse_number();
}

std::array<int64_t, 3> parse_ref(Parser* ps) {
  std::array<int64_t, 3> ref{0, 0, 0};
  ps->consume('[');
  for (int i = 0; i < 3 && ps->ok; ++i) {
    ref[i] = static_cast<int64_t>(ps->parse_number());
    if (i < 2) ps->consume(',');
  }
  ps->consume(']');
  return ref;
}

bool parse_node(Parser* ps, Node* node) {
  ps->consume('{');
  while (ps->ok) {
    std::string key = ps->parse_string();
    ps->consume(':');
    if (key == "op") {
      node->op = ps->parse_string();
    } else if (key == "name") {
      node->name = ps->parse_string();
    } else if (key == "attrs") {
      ps->consume('{');
      if (ps->peek('}')) {
        ++ps->p;
      } else {
        while (ps->ok) {
          std::string k = ps->parse_string();
          ps->consume(':');
          node->attrs[k] = ps->parse_string();
          if (ps->peek(',')) { ++ps->p; continue; }
          ps->consume('}');
          break;
        }
      }
    } else if (key == "inputs") {
      ps->consume('[');
      if (ps->peek(']')) {
        ++ps->p;
      } else {
        while (ps->ok) {
          node->inputs.push_back(parse_ref(ps));
          if (ps->peek(',')) { ++ps->p; continue; }
          ps->consume(']');
          break;
        }
      }
    } else {
      ps->skip_value();
    }
    if (ps->peek(',')) { ++ps->p; continue; }
    ps->consume('}');
    break;
  }
  return ps->ok;
}

bool parse_symbol(const std::string& json, Symbol* sym, std::string* err) {
  Parser ps(json);
  ps.consume('{');
  while (ps.ok) {
    std::string key = ps.parse_string();
    ps.consume(':');
    if (key == "nodes") {
      ps.consume('[');
      if (ps.peek(']')) {
        ++ps.p;
      } else {
        while (ps.ok) {
          Node n;
          if (!parse_node(&ps, &n)) break;
          sym->nodes.push_back(std::move(n));
          if (ps.peek(',')) { ++ps.p; continue; }
          ps.consume(']');
          break;
        }
      }
    } else if (key == "heads") {
      ps.consume('[');
      if (ps.peek(']')) {
        ++ps.p;
      } else {
        while (ps.ok) {
          sym->heads.push_back(parse_ref(&ps));
          if (ps.peek(',')) { ++ps.p; continue; }
          ps.consume(']');
          break;
        }
      }
    } else {
      ps.skip_value();
    }
    ps.skip_ws();
    if (ps.peek(',')) { ++ps.p; continue; }
    ps.consume('}');
    break;
  }
  if (!ps.ok) {
    *err = ps.err;
    return false;
  }
  if (sym->nodes.empty()) {
    *err = "no nodes in graph";
    return false;
  }
  for (const auto& n : sym->nodes) {
    for (const auto& ref : n.inputs) {
      if (ref[0] < 0 || ref[0] >= static_cast<int64_t>(sym->nodes.size())) {
        *err = "input index out of range";
        return false;
      }
    }
  }
  for (const auto& h : sym->heads) {
    if (h[0] < 0 || h[0] >= static_cast<int64_t>(sym->nodes.size())) {
      *err = "head index out of range";
      return false;
    }
  }
  return true;
}

std::string escape(const std::string& s) {
  std::string out;
  for (char c : s) {
    switch (c) {
      case '"': out += "\\\""; break;
      case '\\': out += "\\\\"; break;
      case '\n': out += "\\n"; break;
      case '\t': out += "\\t"; break;
      case '\r': out += "\\r"; break;
      default: out += c;
    }
  }
  return out;
}

void serialize(Symbol* sym) {
  std::ostringstream os;
  os << "{\n  \"nodes\": [\n";
  for (size_t i = 0; i < sym->nodes.size(); ++i) {
    const Node& n = sym->nodes[i];
    os << "    {\"op\": \"" << escape(n.op) << "\", \"name\": \""
       << escape(n.name) << "\", \"attrs\": {";
    bool first = true;
    for (const auto& kv : n.attrs) {
      if (!first) os << ", ";
      first = false;
      os << "\"" << escape(kv.first) << "\": \"" << escape(kv.second)
         << "\"";
    }
    os << "}, \"inputs\": [";
    for (size_t j = 0; j < n.inputs.size(); ++j) {
      if (j) os << ", ";
      os << "[" << n.inputs[j][0] << ", " << n.inputs[j][1] << ", "
         << n.inputs[j][2] << "]";
    }
    os << "]}" << (i + 1 < sym->nodes.size() ? "," : "") << "\n";
  }
  os << "  ],\n  \"heads\": [";
  for (size_t i = 0; i < sym->heads.size(); ++i) {
    if (i) os << ", ";
    os << "[" << sym->heads[i][0] << ", " << sym->heads[i][1] << ", "
       << sym->heads[i][2] << "]";
  }
  os << "],\n  \"mxnet_tpu_version\": 2\n}";
  sym->json = os.str();
}

int fail(const std::string& msg) {
  g_last_error = msg;
  return -1;
}

}  // namespace

extern "C" {

typedef void* SymbolHandle;

const char* MXGetLastError() { return g_last_error.c_str(); }

int MXSymbolCreateFromJSON(const char* json, SymbolHandle* out) {
  if (!json || !out) return fail("null argument");
  auto sym = std::make_unique<Symbol>();
  std::string err;
  if (!parse_symbol(json, sym.get(), &err))
    return fail("invalid symbol JSON: " + err);
  serialize(sym.get());
  *out = sym.release();
  return 0;
}

int MXSymbolCreateFromFile(const char* fname, SymbolHandle* out) {
  if (!fname || !out) return fail("null argument");
  std::ifstream f(fname);
  if (!f) return fail(std::string("cannot open ") + fname);
  std::stringstream ss;
  ss << f.rdbuf();
  return MXSymbolCreateFromJSON(ss.str().c_str(), out);
}

int MXSymbolSaveToJSON(SymbolHandle handle, const char** out) {
  if (!handle || !out) return fail("null argument");
  auto* sym = static_cast<Symbol*>(handle);
  *out = sym->json.c_str();
  return 0;
}

int MXSymbolSaveToFile(SymbolHandle handle, const char* fname) {
  if (!handle || !fname) return fail("null argument");
  auto* sym = static_cast<Symbol*>(handle);
  std::ofstream f(fname);
  if (!f) return fail(std::string("cannot write ") + fname);
  f << sym->json;
  return 0;
}

int MXSymbolListArguments(SymbolHandle handle, uint32_t* out_size,
                          const char*** out_array) {
  if (!handle || !out_size || !out_array) return fail("null argument");
  auto* sym = static_cast<Symbol*>(handle);
  sym->str_store.clear();
  sym->ptr_store.clear();
  for (const auto& n : sym->nodes)
    if (n.op == "null") sym->str_store.push_back(n.name);
  for (const auto& s : sym->str_store) sym->ptr_store.push_back(s.c_str());
  *out_size = static_cast<uint32_t>(sym->ptr_store.size());
  *out_array = sym->ptr_store.data();
  return 0;
}

int MXSymbolListOutputs(SymbolHandle handle, uint32_t* out_size,
                        const char*** out_array) {
  if (!handle || !out_size || !out_array) return fail("null argument");
  auto* sym = static_cast<Symbol*>(handle);
  sym->str_store.clear();
  sym->ptr_store.clear();
  for (const auto& h : sym->heads)
    sym->str_store.push_back(sym->nodes[h[0]].name + "_output");
  for (const auto& s : sym->str_store) sym->ptr_store.push_back(s.c_str());
  *out_size = static_cast<uint32_t>(sym->ptr_store.size());
  *out_array = sym->ptr_store.data();
  return 0;
}

int MXSymbolGetName(SymbolHandle handle, const char** out, int* success) {
  if (!handle || !out || !success) return fail("null argument");
  auto* sym = static_cast<Symbol*>(handle);
  if (sym->heads.empty()) {
    *success = 0;
    *out = nullptr;
    return 0;
  }
  *success = 1;
  *out = sym->nodes[sym->heads[0][0]].name.c_str();
  return 0;
}

int MXSymbolGetNumNodes(SymbolHandle handle, uint32_t* out) {
  if (!handle || !out) return fail("null argument");
  *out = static_cast<uint32_t>(static_cast<Symbol*>(handle)->nodes.size());
  return 0;
}

int MXSymbolGetAttr(SymbolHandle handle, const char* node_name,
                    const char* key, const char** out, int* success) {
  if (!handle || !node_name || !key || !out || !success)
    return fail("null argument");
  auto* sym = static_cast<Symbol*>(handle);
  *success = 0;
  *out = nullptr;
  for (const auto& n : sym->nodes) {
    if (n.name == node_name) {
      auto it = n.attrs.find(key);
      if (it != n.attrs.end()) {
        *success = 1;
        *out = it->second.c_str();
      }
      return 0;
    }
  }
  return fail(std::string("no node named ") + node_name);
}

int MXSymbolFree(SymbolHandle handle) {
  delete static_cast<Symbol*>(handle);
  return 0;
}

}  // extern "C"
