// Fast training-shard parser (proto3 wire format, no protobuf dependency):
// the port's copy of the JAX package's fish_speech_tpu/native/pb_stream.cc.
//
// The training data pipeline reads length-prefixed TextData records
// (schema: fish_speech_tpu_torch/data/protos/). On a single host
// core, protobuf-python dominates shard loading; this parser walks the wire
// format directly and emits flat arrays that numpy views zero-copy.
//
// Wire schema being parsed:
//   TextData  { 1: string source, 2: string name, 4: repeated Sentence }
//   Sentence  { 1: repeated string texts, 3: repeated Semantics }
//   Semantics { 1: repeated uint32 values }   (packed or unpacked)
//
// Exposed C API (ctypes):
//   fs_index_records   : record boundaries of a length-prefixed stream
//   fs_parse_text_data : one record -> flattened semantics + text spans
//
// Build: fish_speech_tpu_torch/native/__init__.py:build_pb, at first use
// (g++ -O2 -shared -fPIC -std=c++17) into build/native/ of the checkout.

#include <cstdint>
#include <cstring>

extern "C" {

// ---------------------------------------------------------------------------
// varint / wire helpers
// ---------------------------------------------------------------------------

static inline bool read_varint(const uint8_t* data, int64_t size, int64_t* pos,
                               uint64_t* out) {
  uint64_t result = 0;
  int shift = 0;
  while (*pos < size && shift < 64) {
    uint8_t byte = data[(*pos)++];
    result |= static_cast<uint64_t>(byte & 0x7F) << shift;
    if ((byte & 0x80) == 0) {
      *out = result;
      return true;
    }
    shift += 7;
  }
  return false;
}

static inline bool skip_field(const uint8_t* data, int64_t size, int64_t* pos,
                              uint32_t wire_type) {
  uint64_t tmp;
  switch (wire_type) {
    case 0:  // varint
      return read_varint(data, size, pos, &tmp);
    case 1:  // fixed64
      *pos += 8;
      return *pos <= size;
    case 2:  // length-delimited
      if (!read_varint(data, size, pos, &tmp)) return false;
      // Validate as unsigned against remaining bytes BEFORE adding: a
      // malicious/corrupt varint near 2^64 would overflow the signed add,
      // go negative, pass `<= size`, and index out of bounds.
      if (tmp > static_cast<uint64_t>(size - *pos)) return false;
      *pos += static_cast<int64_t>(tmp);
      return true;
    case 5:  // fixed32
      *pos += 4;
      return *pos <= size;
    default:
      return false;
  }
}

// ---------------------------------------------------------------------------
// record indexing: 4-byte little-endian size prefix per record
// ---------------------------------------------------------------------------

// Returns the number of records found (<= max_records), or -1 on a
// truncated stream. offsets/lengths describe each record body.
int64_t fs_index_records(const uint8_t* data, int64_t size, int64_t* offsets,
                         int64_t* lengths, int64_t max_records) {
  int64_t pos = 0;
  int64_t n = 0;
  while (pos + 4 <= size && n < max_records) {
    uint32_t rec_len;
    std::memcpy(&rec_len, data + pos, 4);  // little-endian hosts only
    pos += 4;
    if (pos + rec_len > size) return -1;
    offsets[n] = pos;
    lengths[n] = rec_len;
    pos += rec_len;
    n++;
  }
  return n;
}

// ---------------------------------------------------------------------------
// TextData parsing
// ---------------------------------------------------------------------------

// Parse Semantics { 1: repeated uint32 values } into values[]; returns count
// written, -1 on a wire error, or -3 on output-capacity overflow. The two
// MUST stay distinct: callers grow buffers and retry on -3, but a wire
// error on corrupt input must raise, not retry forever.
static int64_t parse_semantics(const uint8_t* data, int64_t size,
                               int32_t* values, int64_t cap) {
  int64_t pos = 0;
  int64_t n = 0;
  while (pos < size) {
    uint64_t key;
    if (!read_varint(data, size, &pos, &key)) return -1;
    uint32_t field = static_cast<uint32_t>(key >> 3);
    uint32_t wire = static_cast<uint32_t>(key & 7);
    if (field == 1 && wire == 2) {  // packed
      uint64_t len;
      if (!read_varint(data, size, &pos, &len)) return -1;
      if (len > static_cast<uint64_t>(size - pos)) return -1;
      int64_t end = pos + static_cast<int64_t>(len);
      while (pos < end) {
        uint64_t v;
        if (!read_varint(data, size, &pos, &v)) return -1;
        if (n >= cap) return -3;
        values[n++] = static_cast<int32_t>(v);
      }
    } else if (field == 1 && wire == 0) {  // unpacked
      uint64_t v;
      if (!read_varint(data, size, &pos, &v)) return -1;
      if (n >= cap) return -3;
      values[n++] = static_cast<int32_t>(v);
    } else {
      if (!skip_field(data, size, &pos, wire)) return -1;
    }
  }
  return n;
}

// Parse one TextData record.
//
// Outputs (all caller-allocated):
//   values[val_cap]            flattened int32 semantics values
//   row_starts[row_cap+1]      start index into values per semantics row
//   row_sentence[row_cap]      owning sentence index per row
//   text_spans[2*text_cap]     (offset, length) pairs into the record buffer
//                              for each sentence's FIRST text
//   sent_text_count[text_cap]  number of texts seen per sentence
// Returns 0 on success; fills out_counts = {n_sentences, n_rows, n_values}.
int32_t fs_parse_text_data(const uint8_t* data, int64_t size, int32_t* values,
                           int64_t val_cap, int64_t* row_starts,
                           int64_t* row_sentence, int64_t row_cap,
                           int64_t* text_spans, int32_t* sent_text_count,
                           int64_t text_cap, int64_t* out_counts) {
  int64_t pos = 0;
  int64_t n_sent = 0, n_rows = 0, n_vals = 0;
  while (pos < size) {
    uint64_t key;
    if (!read_varint(data, size, &pos, &key)) return -1;
    uint32_t field = static_cast<uint32_t>(key >> 3);
    uint32_t wire = static_cast<uint32_t>(key & 7);
    if (field == 4 && wire == 2) {  // Sentence
      uint64_t slen;
      if (!read_varint(data, size, &pos, &slen)) return -2;
      if (slen > static_cast<uint64_t>(size - pos)) return -2;
      int64_t send = pos + static_cast<int64_t>(slen);
      if (n_sent >= text_cap) return -3;
      text_spans[2 * n_sent] = -1;
      text_spans[2 * n_sent + 1] = 0;
      sent_text_count[n_sent] = 0;
      // walk sentence fields
      int64_t sp = pos;
      while (sp < send) {
        uint64_t skey;
        if (!read_varint(data, size, &sp, &skey)) return -2;
        uint32_t sfield = static_cast<uint32_t>(skey >> 3);
        uint32_t swire = static_cast<uint32_t>(skey & 7);
        if (sfield == 1 && swire == 2) {  // text
          uint64_t tlen;
          if (!read_varint(data, size, &sp, &tlen)) return -2;
          if (tlen > static_cast<uint64_t>(size - sp)) return -2;
          if (sent_text_count[n_sent] == 0) {
            text_spans[2 * n_sent] = sp;
            text_spans[2 * n_sent + 1] = static_cast<int64_t>(tlen);
          }
          sent_text_count[n_sent]++;
          sp += static_cast<int64_t>(tlen);
        } else if (sfield == 3 && swire == 2) {  // Semantics row
          uint64_t mlen;
          if (!read_varint(data, size, &sp, &mlen)) return -2;
          if (mlen > static_cast<uint64_t>(size - sp)) return -2;
          if (n_rows >= row_cap) return -3;
          row_starts[n_rows] = n_vals;
          row_sentence[n_rows] = n_sent;
          int64_t wrote = parse_semantics(data + sp, static_cast<int64_t>(mlen),
                                          values + n_vals, val_cap - n_vals);
          if (wrote == -3) return -3;
          if (wrote < 0) return -4;
          n_vals += wrote;
          n_rows++;
          sp += static_cast<int64_t>(mlen);
        } else {
          if (!skip_field(data, size, &sp, swire)) return -2;
        }
      }
      n_sent++;
      pos = send;
    } else {
      if (!skip_field(data, size, &pos, wire)) return -1;
    }
  }
  row_starts[n_rows] = n_vals;
  out_counts[0] = n_sent;
  out_counts[1] = n_rows;
  out_counts[2] = n_vals;
  return 0;
}

// ---------------------------------------------------------------------------
// whole-shard parsing (one call; Python marshals flat arrays zero-copy-ish)
// ---------------------------------------------------------------------------

// Parses every length-prefixed TextData record in `data`.
// Flat outputs:
//   values[val_cap]               all semantics values
//   row_starts[row_cap+1]         value start per semantics row
//   row_sentence[row_cap]         GLOBAL sentence index per row
//   sent_record[sent_cap]         record index per sentence
//   text_spans[2*sent_cap]        (abs offset, length) of first text per
//                                 sentence (into `data`)
//   out_counts = {n_records, n_sentences, n_rows, n_values}
// Returns 0 ok, -1/-4 wire error (caller raises), -3 capacity overflow
// (caller grows + retries).
int32_t fs_parse_shard(const uint8_t* data, int64_t size, int32_t* values,
                       int64_t val_cap, int64_t* row_starts,
                       int64_t* row_sentence, int64_t row_cap,
                       int64_t* sent_record, int64_t* text_spans,
                       int64_t sent_cap, int64_t* out_counts) {
  int64_t pos = 0;
  int64_t n_rec = 0, n_sent = 0, n_rows = 0, n_vals = 0;
  while (pos + 4 <= size) {
    uint32_t rec_len;
    std::memcpy(&rec_len, data + pos, 4);
    pos += 4;
    int64_t rend = pos + rec_len;
    if (rend > size) return -1;

    int64_t p = pos;
    while (p < rend) {
      uint64_t key;
      if (!read_varint(data, rend, &p, &key)) return -1;
      uint32_t field = static_cast<uint32_t>(key >> 3);
      uint32_t wire = static_cast<uint32_t>(key & 7);
      if (field == 4 && wire == 2) {  // Sentence
        uint64_t slen;
        if (!read_varint(data, rend, &p, &slen)) return -1;
        if (slen > static_cast<uint64_t>(rend - p)) return -1;
        int64_t send = p + static_cast<int64_t>(slen);
        if (n_sent >= sent_cap) return -3;
        sent_record[n_sent] = n_rec;
        text_spans[2 * n_sent] = -1;
        text_spans[2 * n_sent + 1] = 0;
        int64_t sp = p;
        bool have_text = false;
        while (sp < send) {
          uint64_t skey;
          if (!read_varint(data, send, &sp, &skey)) return -1;
          uint32_t sfield = static_cast<uint32_t>(skey >> 3);
          uint32_t swire = static_cast<uint32_t>(skey & 7);
          if (sfield == 1 && swire == 2) {
            uint64_t tlen;
            if (!read_varint(data, send, &sp, &tlen)) return -1;
            if (tlen > static_cast<uint64_t>(send - sp)) return -1;
            if (!have_text) {
              text_spans[2 * n_sent] = sp;
              text_spans[2 * n_sent + 1] = static_cast<int64_t>(tlen);
              have_text = true;
            }
            sp += static_cast<int64_t>(tlen);
          } else if (sfield == 3 && swire == 2) {
            uint64_t mlen;
            if (!read_varint(data, send, &sp, &mlen)) return -1;
            if (mlen > static_cast<uint64_t>(send - sp)) return -1;
            if (n_rows >= row_cap) return -3;
            row_starts[n_rows] = n_vals;
            row_sentence[n_rows] = n_sent;
            int64_t wrote =
                parse_semantics(data + sp, static_cast<int64_t>(mlen),
                                values + n_vals, val_cap - n_vals);
            if (wrote == -3) return -3;  // capacity: caller grows + retries
            if (wrote < 0) return -4;    // wire error: caller must raise
            n_vals += wrote;
            n_rows++;
            sp += static_cast<int64_t>(mlen);
          } else {
            if (!skip_field(data, send, &sp, swire)) return -1;
          }
        }
        n_sent++;
        p = send;
      } else {
        if (!skip_field(data, rend, &p, wire)) return -1;
      }
    }
    pos = rend;
    n_rec++;
  }
  if (pos != size) return -1;
  row_starts[n_rows] = n_vals;
  out_counts[0] = n_rec;
  out_counts[1] = n_sent;
  out_counts[2] = n_rows;
  out_counts[3] = n_vals;
  return 0;
}

}  // extern "C"
