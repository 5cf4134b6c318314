// Native radix-tree KV index for KV-aware routing.
//
// Copied from dynamo_tpu/native/kv_indexer.cpp (the C++ port of the
// router indexer hot path, dynamo_tpu/kv_router/indexer.py; reference
// semantics: lib/llm/src/kv_router/indexer.rs:163-388): a prefix
// tree keyed by content-only page hashes, per-node worker sets, per-worker
// block_hash -> node lookup for O(1) event application, and a prefix walk
// accumulating per-worker overlap counts. The reference keeps this in native
// code (Rust) because it sits on the per-request routing path and the
// steady-state event path; this is our native-runtime equivalent, loaded via
// ctypes (dynamo_tpu_torch/native/__init__.py) with the Python tree as
// fallback.
//
// Thread model: single owner (the Python event loop) — no locking, matching
// the reference's single-threaded owner task (indexer.rs:525-593).

#include <cstdint>
#include <cstddef>
#include <unordered_map>
#include <unordered_set>
#include <vector>

namespace {

struct Node {
    uint64_t tokens_hash;
    Node* parent;
    std::unordered_map<uint64_t, Node*> children;      // tokens_hash -> node
    std::unordered_map<uint64_t, uint64_t> workers;    // worker -> block_hash
};

struct Tree {
    Node root{0, nullptr, {}, {}};
    // worker -> (block_hash -> node)
    std::unordered_map<uint64_t, std::unordered_map<uint64_t, Node*>> lookup;

    ~Tree() { free_children(&root); }

    static void free_children(Node* n) {
        for (auto& kv : n->children) {
            free_children(kv.second);
            delete kv.second;
        }
        n->children.clear();
    }

    void maybe_prune(Node* node) {
        while (node->parent != nullptr && node->workers.empty() &&
               node->children.empty()) {
            Node* parent = node->parent;
            auto it = parent->children.find(node->tokens_hash);
            if (it != parent->children.end() && it->second == node) {
                parent->children.erase(it);
            }
            delete node;
            node = parent;
        }
    }
};

}  // namespace

extern "C" {

void* dtr_new() { return new Tree(); }

void dtr_free(void* t) { delete static_cast<Tree*>(t); }

// Stored event: attach a chained run of blocks under parent_hash (0 = root).
// Unknown parent => drop (mid-sequence pages must not forge root edges).
void dtr_apply_stored(void* tp, uint64_t worker, uint64_t parent_hash,
                      size_t n, const uint64_t* block_hashes,
                      const uint64_t* tokens_hashes) {
    Tree* t = static_cast<Tree*>(tp);
    auto& table = t->lookup[worker];
    Node* node;
    if (parent_hash == 0) {
        node = &t->root;
    } else {
        auto it = table.find(parent_hash);
        if (it == table.end()) return;
        node = it->second;
    }
    for (size_t i = 0; i < n; i++) {
        Node* child;
        auto it = node->children.find(tokens_hashes[i]);
        if (it == node->children.end()) {
            child = new Node{tokens_hashes[i], node, {}, {}};
            node->children.emplace(tokens_hashes[i], child);
        } else {
            child = it->second;
        }
        // re-store under a new block_hash: drop the stale table mapping,
        // else pruning via the new hash leaves table[old] dangling
        // (invariant: table entries are exactly {bh : node.workers[w]==bh})
        auto wit = child->workers.find(worker);
        if (wit != child->workers.end() && wit->second != block_hashes[i]) {
            table.erase(wit->second);
        }
        child->workers[worker] = block_hashes[i];
        table[block_hashes[i]] = child;
        node = child;
    }
}

void dtr_apply_removed(void* tp, uint64_t worker, size_t n,
                       const uint64_t* block_hashes) {
    Tree* t = static_cast<Tree*>(tp);
    auto lit = t->lookup.find(worker);
    if (lit == t->lookup.end()) return;
    auto& table = lit->second;
    for (size_t i = 0; i < n; i++) {
        auto it = table.find(block_hashes[i]);
        if (it == table.end()) continue;
        Node* node = it->second;
        table.erase(it);
        auto wit = node->workers.find(worker);
        if (wit != node->workers.end() && wit->second == block_hashes[i]) {
            node->workers.erase(wit);
        }
        t->maybe_prune(node);
    }
}

void dtr_remove_worker(void* tp, uint64_t worker) {
    Tree* t = static_cast<Tree*>(tp);
    auto lit = t->lookup.find(worker);
    if (lit == t->lookup.end()) return;
    std::unordered_set<Node*> nodes;
    for (auto& kv : lit->second) nodes.insert(kv.second);
    t->lookup.erase(lit);
    for (Node* node : nodes) {
        node->workers.erase(worker);
        t->maybe_prune(node);
    }
}

// Prefix walk: per-worker count of leading query pages held. Writes up to
// cap (worker, score) pairs; returns the number written.
size_t dtr_find_matches(void* tp, size_t n, const uint64_t* page_hashes,
                        size_t cap, uint64_t* out_workers,
                        uint32_t* out_scores) {
    Tree* t = static_cast<Tree*>(tp);
    std::unordered_map<uint64_t, uint32_t> scores;
    Node* node = &t->root;
    for (size_t i = 0; i < n; i++) {
        auto it = node->children.find(page_hashes[i]);
        if (it == node->children.end()) break;
        node = it->second;
        for (auto& kv : node->workers) scores[kv.first]++;
    }
    size_t written = 0;
    for (auto& kv : scores) {
        if (written >= cap) break;
        out_workers[written] = kv.first;
        out_scores[written] = kv.second;
        written++;
    }
    return written;
}

size_t dtr_num_nodes(void* tp) {
    Tree* t = static_cast<Tree*>(tp);
    std::vector<Node*> stack{&t->root};
    size_t count = 0;
    while (!stack.empty()) {
        Node* n = stack.back();
        stack.pop_back();
        count++;
        for (auto& kv : n->children) stack.push_back(kv.second);
    }
    return count - 1;  // exclude root
}

size_t dtr_worker_block_count(void* tp, uint64_t worker) {
    Tree* t = static_cast<Tree*>(tp);
    auto it = t->lookup.find(worker);
    return it == t->lookup.end() ? 0 : it->second.size();
}

}  // extern "C"
