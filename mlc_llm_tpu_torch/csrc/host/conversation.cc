// C++ conversation templating + streaming text guards.
//
// Native twin of mlc_llm_tpu_torch/conversation.py (a copy of the JAX
// package's native conversation engine: the port keeps its own), after
// the reference's C++ Conversation engine (llm_chat.cc:35-340): 5
// separator styles, incremental re-prompting, stop-string scanning and
// UTF-8-safe crop for token streaming. Exposed as a C API for ctypes; the
// Python twin is the source of truth for template CONTENT (system
// strings/roles are passed in, not duplicated here).

#include <cstdint>
#include <cstring>
#include <string>
#include <vector>

namespace {

enum class SepStyle : int32_t {
  kSingle = 0,
  kTwo = 1,
  kDolly = 2,
  kOasst = 3,
  kMoss = 4,
};

struct Conversation {
  std::string system;
  std::string roles[2];
  SepStyle style;
  std::string sep;
  std::string sep2;
  std::vector<std::pair<int32_t, std::string>> messages;  // (role_idx, text)
  std::vector<bool> has_text;
  size_t offset = 0;
  size_t cur = 0;  // index of last message materialized into a prompt

  void RenderOne(std::string* out, size_t j, int32_t role_idx,
                 const std::string& msg, bool has) const {
    const std::string& role = roles[role_idx];
    const std::string seps[2] = {sep, sep2};
    switch (style) {
      case SepStyle::kSingle:
        *out += sep + " " + role + ":";
        if (has) *out += " " + msg;
        break;
      case SepStyle::kTwo:
        *out += role + ":";
        if (has) *out += " " + msg + seps[j % 2];
        break;
      case SepStyle::kDolly:
        *out += role + ":\n";
        if (has) {
          *out += msg + seps[j % 2];
          if (j % 2 == 1) *out += "\n";
        }
        break;
      case SepStyle::kOasst:
        *out += role;
        if (has) *out += msg + sep;
        break;
      case SepStyle::kMoss:
        *out += role + ":";
        if (has) *out += " " + msg + seps[j % 2] + "\n";
        break;
    }
  }

  std::string GetPrompt() {
    std::string out = system;
    if (style == SepStyle::kTwo) out += sep;
    for (size_t j = 0; j < messages.size(); ++j) {
      RenderOne(&out, j, messages[j].first, messages[j].second, has_text[j]);
    }
    cur = messages.empty() ? 0 : messages.size() - 1;
    return out;
  }

  std::string GetPromptUnprocessed() {
    if (cur == 0) return GetPrompt();
    std::string out;
    switch (style) {
      case SepStyle::kTwo:
      case SepStyle::kDolly:
        out = sep2;
        break;
      case SepStyle::kOasst:
        out = sep;
        break;
      case SepStyle::kMoss:
      case SepStyle::kSingle:  // new turns are a pure suffix
        break;
    }
    for (size_t j = cur + 1; j < messages.size(); ++j) {
      RenderOne(&out, j, messages[j].first, messages[j].second, has_text[j]);
    }
    cur = messages.size() - 1;
    return out;
  }
};

thread_local std::string g_result;

}  // namespace

extern "C" {

void* mlc_conv_create(const char* system, const char* role0, const char* role1,
                      int32_t style, const char* sep, const char* sep2) {
  auto* c = new Conversation();
  c->system = system;
  c->roles[0] = role0;
  c->roles[1] = role1;
  c->style = static_cast<SepStyle>(style);
  c->sep = sep;
  c->sep2 = sep2 ? sep2 : "";
  return c;
}

void mlc_conv_destroy(void* h) { delete static_cast<Conversation*>(h); }

void mlc_conv_append(void* h, int32_t role_idx, const char* msg) {
  auto* c = static_cast<Conversation*>(h);
  c->messages.emplace_back(role_idx, msg ? msg : "");
  c->has_text.push_back(msg != nullptr);
}

void mlc_conv_update_last(void* h, const char* msg) {
  auto* c = static_cast<Conversation*>(h);
  if (!c->messages.empty()) {
    c->messages.back().second = msg;
    c->has_text.back() = true;
  }
}

void mlc_conv_set_offset(void* h, int32_t offset) {
  static_cast<Conversation*>(h)->offset = offset;
}

void mlc_conv_reset(void* h) {
  auto* c = static_cast<Conversation*>(h);
  c->messages.resize(c->offset);
  c->has_text.resize(c->offset);
  c->cur = 0;
}

const char* mlc_conv_get_prompt(void* h) {
  g_result = static_cast<Conversation*>(h)->GetPrompt();
  return g_result.c_str();
}

const char* mlc_conv_get_prompt_unprocessed(void* h) {
  g_result = static_cast<Conversation*>(h)->GetPromptUnprocessed();
  return g_result.c_str();
}

// ---------------------------------------------------------------- streaming

// Largest prefix length of `text` that is complete UTF-8 (the analog of
// FindEffectiveUTF8Pos, the reference's llm_chat.cc:726-742).
int64_t mlc_utf8_safe_prefix(const char* text, int64_t len) {
  int64_t i = len;
  // walk back over at most 3 continuation bytes
  int back = 0;
  while (i > 0 && back < 4) {
    unsigned char b = static_cast<unsigned char>(text[i - 1]);
    if ((b & 0xC0) != 0x80) {  // lead or ASCII byte at i-1
      int need = (b < 0x80) ? 1 : (b >= 0xF0) ? 4 : (b >= 0xE0) ? 3 : (b >= 0xC0) ? 2 : -1;
      if (need < 0) return i;  // invalid byte: emit through it
      int have = static_cast<int>(len - (i - 1));
      return (have >= need) ? len : i - 1;
    }
    --i;
    ++back;
  }
  return i;
}

// Position of `stop` in text, or -1; *holdback gets the number of tail
// bytes that could still be a stop-string prefix (don't emit them yet).
int64_t mlc_find_stop(const char* text, int64_t len, const char* stop,
                      int64_t* holdback) {
  std::string t(text, len);
  std::string s(stop);
  *holdback = 0;
  if (s.empty()) return -1;
  size_t pos = t.find(s);
  if (pos != std::string::npos) return static_cast<int64_t>(pos);
  // longest suffix of t that is a prefix of s
  size_t maxk = std::min(t.size(), s.size() - 1);
  for (size_t k = maxk; k > 0; --k) {
    if (t.compare(t.size() - k, k, s, 0, k) == 0) {
      *holdback = static_cast<int64_t>(k);
      break;
    }
  }
  return -1;
}

}  // extern "C"
