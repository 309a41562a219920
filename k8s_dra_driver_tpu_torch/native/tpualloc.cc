// tpualloc.cc — native allocator search core (C ABI, no dependencies).
//
// The port's copy of the JAX package's search core, built by
// utils/nativebuild.py into build/native/libtpualloc.so.  The hot half
// of the structured-parameters allocator (allocator/allocator.py
// Allocator._search): the bounded DFS over per-request candidate lists
// with shared-token conflict pruning, incremental matchAttribute
// constraint checking, and failed-sibling deduplication.  Eligibility
// (CEL matching, node filtering, ordering) stays in Python — this core
// receives the *prepared* problem with tokens and constraint-attribute
// values interned to small integers, and must pick exactly the devices
// the Python DFS would pick (tests/test_torch_native_alloc.py diffs the
// two engines on randomized pools; the same conformance contract as
// tpudiscovery.cc).
//
// Problem text protocol (one token per line group, whitespace-split):
//   budget <N>
//   ntokens <T>          globally interned shared-token id space
//   nconstraints <C>
//   request <name> count <K> mode exact|all
//   cand <id> tokens <t1,t2|-> cvals <v1,...,vC|->
//     cvals: one interned value id per constraint; -1 = device lacks
//     the attribute (constraint fails), -2 = constraint does not
//     scope this request (ignored).  Candidate order IS the Python
//     eligible order — the DFS must preserve it for pick-parity.
// Result written to the caller's buffer:
//   ok <name>=<id,id,...> <name>=...   ("=" alone for empty picks)
//   fail budget | fail nosolution
// Return codes: 0 ok, 1 no solution, 2 budget exhausted,
//   3 parse error, 4 buffer too small.

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <map>
#include <set>
#include <sstream>
#include <string>
#include <vector>

namespace {

struct Cand {
  long id = 0;
  std::vector<int> tokens;   // interned shared-token ids
  std::vector<int> cvals;    // per-constraint value id / -1 / -2
};

struct Request {
  std::string name;
  long count = 0;
  bool all_mode = false;
  std::vector<Cand> cands;
};

struct Problem {
  long budget = 100000;
  int ntokens = 0;
  int nconstraints = 0;
  std::vector<Request> requests;
};

bool parse_int_list(const std::string &s, std::vector<int> *out) {
  if (s == "-") return true;  // empty list marker
  std::stringstream ss(s);
  std::string part;
  while (std::getline(ss, part, ',')) {
    if (part.empty()) return false;
    try {
      out->push_back(std::stoi(part));
    } catch (const std::exception &) {
      // non-numeric / out-of-range must surface as rc=3 "fail parse",
      // never as an exception escaping the C ABI
      return false;
    }
  }
  return true;
}

bool parse_problem(const char *text, Problem *p) {
  std::stringstream in(text);
  std::string word;
  Request *cur = nullptr;
  while (in >> word) {
    if (word == "budget") {
      if (!(in >> p->budget)) return false;
    } else if (word == "ntokens") {
      if (!(in >> p->ntokens)) return false;
    } else if (word == "nconstraints") {
      if (!(in >> p->nconstraints)) return false;
    } else if (word == "request") {
      Request r;
      std::string kw, mode;
      if (!(in >> r.name >> kw >> r.count) || kw != "count") return false;
      if (!(in >> kw >> mode) || kw != "mode") return false;
      if (mode == "all") r.all_mode = true;
      else if (mode != "exact") return false;
      p->requests.push_back(std::move(r));
      cur = &p->requests.back();
    } else if (word == "cand") {
      if (cur == nullptr) return false;
      Cand c;
      std::string kw, toks, vals;
      if (!(in >> c.id >> kw >> toks) || kw != "tokens") return false;
      if (!(in >> kw >> vals) || kw != "cvals") return false;
      if (!parse_int_list(toks, &c.tokens)) return false;
      if (!parse_int_list(vals, &c.cvals)) return false;
      if (static_cast<int>(c.cvals.size()) != p->nconstraints)
        return false;
      cur->cands.push_back(std::move(c));
    } else {
      return false;
    }
  }
  return true;
}

struct BudgetExhausted {};

class Solver {
 public:
  explicit Solver(const Problem &p)
      : p_(p), used_tokens_(p.ntokens, 0),
        chosen_(p.requests.size()), chosen_set_(p.requests.size(), false),
        budget_(p.budget) {}

  // returns true on success; chosen_ holds the picks
  bool solve() { return search(0); }
  bool budget_hit() const { return budget_hit_; }
  const std::vector<std::vector<const Cand *>> &chosen() const {
    return chosen_;
  }

 private:
  bool tokens_free(const Cand &c, const std::vector<uint8_t> &used) const {
    for (int t : c.tokens)
      if (used[t]) return false;
    return true;
  }

  // Mirrors _constraints_ok: every constraint's scoped chosen devices
  // must share one present value.
  bool constraints_ok() const {
    for (int con = 0; con < p_.nconstraints; ++con) {
      int seen = INT32_MIN;
      for (size_t ri = 0; ri < chosen_.size(); ++ri) {
        if (!chosen_set_[ri]) continue;
        for (const Cand *c : chosen_[ri]) {
          int v = c->cvals[con];
          if (v == -2) continue;      // constraint does not scope ri
          if (v == -1) return false;  // attribute missing
          if (seen == INT32_MIN) seen = v;
          else if (v != seen) return false;
        }
      }
    }
    return true;
  }

  bool search(size_t idx) {
    if (idx == p_.requests.size()) return true;
    const Request &req = p_.requests[idx];

    std::vector<const Cand *> free;
    for (const Cand &c : req.cands)
      if (tokens_free(c, used_tokens_)) free.push_back(&c);

    if (req.all_mode) {
      // greedy: take every candidate that fits (mirrors the Python
      // ALL-mode loop over `free` with running token accumulation)
      std::vector<const Cand *> picked;
      std::vector<uint8_t> tokens = used_tokens_;
      for (const Cand *c : free) {
        if (!tokens_free(*c, tokens)) continue;
        picked.push_back(c);
        for (int t : c->tokens) tokens[t] = 1;
      }
      if (picked.empty()) return false;
      chosen_[idx] = picked;
      chosen_set_[idx] = true;
      if (constraints_ok()) {
        std::swap(used_tokens_, tokens);
        if (search(idx + 1)) return true;
        std::swap(used_tokens_, tokens);
      }
      chosen_[idx].clear();
      chosen_set_[idx] = false;
      return false;
    }

    if (req.count == 0) {  // vacuous request allocates nothing
      chosen_[idx].clear();
      chosen_set_[idx] = true;
      if (search(idx + 1)) return true;
      chosen_set_[idx] = false;
      return false;
    }

    if (static_cast<long>(free.size()) < req.count) return false;
    chosen_[idx].clear();
    chosen_set_[idx] = true;
    bool found = false;
    try {
      found = pick(idx, req, free, 0);
    } catch (const BudgetExhausted &) {
      chosen_set_[idx] = false;
      throw;
    }
    if (!found) {
      chosen_[idx].clear();
      chosen_set_[idx] = false;
    }
    return found;
  }

  // Mirrors the recursive pick(): one candidate at a time from `start`,
  // failed-sibling signatures tried once per level.
  bool pick(size_t idx, const Request &req,
            const std::vector<const Cand *> &free, size_t start) {
    if (--budget_ < 0) {
      budget_hit_ = true;
      throw BudgetExhausted{};
    }
    std::vector<const Cand *> &partial = chosen_[idx];
    if (static_cast<long>(partial.size()) == req.count)
      return search(idx + 1);

    long need = req.count - static_cast<long>(partial.size());
    std::set<std::pair<std::vector<int>, std::vector<int>>> failed;
    for (size_t j = start; j < free.size(); ++j) {
      if (static_cast<long>(free.size() - j) < need) break;
      const Cand *c = free[j];
      bool clash = false;
      for (int t : c->tokens)
        if (used_tokens_[t]) { clash = true; break; }
      if (clash) continue;
      auto sig = std::make_pair(c->tokens, c->cvals);
      if (failed.count(sig)) continue;
      partial.push_back(c);
      bool ok = false;
      if (constraints_ok()) {
        for (int t : c->tokens) used_tokens_[t] = 1;
        ok = pick(idx, req, free, j + 1);
        if (!ok)
          for (int t : c->tokens) used_tokens_[t] = 0;
      }
      if (ok) return true;
      partial.pop_back();
      failed.insert(std::move(sig));
    }
    return false;
  }

  const Problem &p_;
  std::vector<uint8_t> used_tokens_;
  std::vector<std::vector<const Cand *>> chosen_;
  std::vector<uint8_t> chosen_set_;
  long budget_;
  bool budget_hit_ = false;
};

}  // namespace

extern "C" int tpu_allocate(const char *problem_text, char *out,
                            int out_cap) {
  Problem p;
  if (!parse_problem(problem_text, &p)) {
    std::snprintf(out, out_cap, "fail parse");
    return 3;
  }
  Solver s(p);
  bool ok = false;
  try {
    ok = s.solve();
  } catch (const BudgetExhausted &) {
    std::snprintf(out, out_cap, "fail budget");
    return 2;
  }
  if (!ok) {
    std::snprintf(out, out_cap, "fail nosolution");
    return 1;
  }
  std::string result = "ok";
  for (size_t i = 0; i < p.requests.size(); ++i) {
    result += " " + p.requests[i].name + "=";
    const auto &picks = s.chosen()[i];
    for (size_t j = 0; j < picks.size(); ++j) {
      if (j) result += ",";
      result += std::to_string(picks[j]->id);
    }
  }
  if (static_cast<int>(result.size()) + 1 > out_cap) return 4;
  std::memcpy(out, result.c_str(), result.size() + 1);
  return 0;
}

extern "C" const char *tpu_alloc_version() { return "tpualloc/0.1.0"; }
