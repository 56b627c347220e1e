"""Training dataset: weighted speaker-group sampling, causal windowing,
sentence packing into (num_codebooks+1, T) token/label matrices, and a
numpy collator with padding masks.

Reference behaviors: `fish_speech/datasets/semantic.py` —
  * groups = TextData records; weighted by sentence count;
  * causal window of ~max_length//20 consecutive sentences per sample;
  * per-sentence prompt: "Speak out the provided text." +
    `<|speaker:user|> text <|im_end|>` +
    `<|speaker:assistant|> <|voice|>` + VQ codes (cal_loss) + `<|im_end|>`;
  * labels rows 1..C carry the codes at shifted VQ positions, -100
    elsewhere, 0 (codebook pad) at the final position;
  * collator right-pads tokens with EOS / codebook pad and labels with -100.

Pure numpy + threads (no torch DataLoader); rank/worker sharding
is explicit via (shard_id, num_shards).

Kept in the port as its own copy of `fish_speech_tpu/data/dataset.py`, so the port
never imports the JAX package; the tests hold the two to each other. Left
out: the C++ shard parser (`fish_speech_tpu/native/`; shards are read with
protobuf, which gives the same groups) and the codec-training
`VQGANDataset` (codec training is not ported).
"""

from __future__ import annotations

import random
import threading
from dataclasses import dataclass
from pathlib import Path
from queue import Full, Queue
from random import Random
from typing import Iterator, List, Optional, Sequence

import numpy as np

from fish_speech_tpu_torch.data.clean import clean_text
from fish_speech_tpu_torch.data.protos import SampledData
from fish_speech_tpu_torch.data.stream import read_pb_stream
from fish_speech_tpu_torch.sequence import ContentSequence, TextPart, VQPart
from fish_speech_tpu_torch.tokenizer import EOS_TOKEN, FishTokenizer

CODEBOOK_PAD_TOKEN_ID = 0
IGNORE_INDEX = -100


def expand_proto_files(proto_files: Sequence[str]) -> List[Path]:
    from fish_speech_tpu_torch.utils.file import braceexpand

    out: List[Path] = []
    for filename in proto_files:
        for expanded in braceexpand(str(filename)):
            p = Path(expanded)
            if p.is_file():
                out.append(p)
            elif p.is_dir():
                out.extend(p.rglob("*.proto"))
                out.extend(p.rglob("*.protos"))
            else:
                raise ValueError(f"{p} is not a file or directory")
    return sorted(out)


class SemanticIterableDataset:
    """Infinite sampler over packed text+semantic sequences."""

    def __init__(
        self,
        proto_files: Sequence[str],
        tokenizer: FishTokenizer,
        seed: int = 42,
        max_length: int = 1024,
        causal: bool = True,
        num_codebooks: Optional[int] = None,
        skip_text_prob: float = 0.0,
        shard_id: int = 0,
        num_shards: int = 1,
    ):
        self.proto_files = proto_files
        self.tokenizer = tokenizer
        self.seed = seed
        self.max_length = max_length
        self.causal = causal
        self.num_codebooks = num_codebooks
        self.skip_text_prob = skip_text_prob
        self.shard_id = shard_id
        self.num_shards = num_shards
        self.groups = None
        self.group_weights = None
        self.rng = random.Random(seed + shard_id)

    def _load_groups(self):
        files = expand_proto_files(self.proto_files)
        Random(self.seed).shuffle(files)
        if len(files) < self.num_shards:
            files = files * (self.num_shards // max(len(files), 1) + 1)
        files = files[self.shard_id :: self.num_shards]

        self.groups = []
        for filename in files:
            with open(filename, "rb") as f:
                for text_data in read_pb_stream(f):
                    self.groups.append(text_data)
        Random(self.seed).shuffle(self.groups)
        if not self.groups:
            raise ValueError(f"No data found in {self.proto_files}")
        self.group_weights = [len(g.sentences) for g in self.groups]

    def sample_data(self) -> SampledData:
        if self.groups is None:
            self._load_groups()
        num_samples = self.max_length // 20
        group = self.rng.choices(self.groups, weights=self.group_weights, k=1)[0]
        if self.causal:
            if num_samples >= len(group.sentences):
                samples = list(group.sentences)
            else:
                begin = self.rng.randint(0, len(group.sentences) - num_samples)
                samples = list(group.sentences[begin : begin + num_samples])
        else:
            samples = self.rng.choices(
                group.sentences, k=min(num_samples, len(group.sentences))
            )
        import types

        return types.SimpleNamespace(
            source=getattr(group, "source", ""),
            name=getattr(group, "name", ""),
            samples=samples,
        )

    def pack_sentences(self, sentences: List[str], semantics, skip_text=False):
        seq = ContentSequence()
        seq.append(TextPart(text="Speak out the provided text."))

        cated = " ".join(sentences) if not skip_text else "<|skip_text|>"
        seq.append(TextPart(text=f"<|speaker:user|> {cated}"), add_end=True)

        vq_codes = np.asarray(  # protobuf Sentence.semantics
            [list(x.values) for x in semantics[0]], dtype=np.int32
        )
        vq_part = VQPart(codes=vq_codes, cal_loss=True)
        seq.append(
            [TextPart(text="<|speaker:assistant|> <|voice|>"), vq_part],
            add_end=True,
        )

        encoded = seq.encode(self.tokenizer, add_shift=True)
        num_codebooks = (
            len(semantics[0]) if self.num_codebooks is None else self.num_codebooks
        )

        t = len(encoded.tokens)
        tokens = np.zeros((num_codebooks + 1, t), dtype=np.int32)
        tokens[0] = encoded.tokens
        all_vq = np.concatenate(encoded.vq_parts, axis=1)
        tokens[1:, encoded.vq_mask_tokens] = all_vq[:, : encoded.vq_mask_tokens.sum()]

        labels = np.full((num_codebooks + 1, t), IGNORE_INDEX, dtype=np.int32)
        labels[0] = encoded.labels
        labels[1:, encoded.vq_mask_labels] = all_vq[
            :, all_vq.shape[1] - encoded.vq_mask_labels.sum() :
        ]
        labels[1:, -1:] = CODEBOOK_PAD_TOKEN_ID

        assert (tokens[1:, ~encoded.vq_mask_tokens] == CODEBOOK_PAD_TOKEN_ID).all()
        return tokens, labels

    def augment(self):
        response = self.sample_data()
        if len(response.samples) == 0:
            return None
        all_tokens, all_labels = [], []
        for sentence in response.samples:
            text = clean_text(self.rng.choice(list(sentence.texts)))
            tokens, labels = self.pack_sentences(
                sentences=[text],
                semantics=[sentence.semantics],
                skip_text=self.rng.random() < self.skip_text_prob,
            )
            all_tokens.append(tokens)
            all_labels.append(labels)
        return {
            "tokens": np.concatenate(all_tokens, axis=1),
            "labels": np.concatenate(all_labels, axis=1),
        }

    def __iter__(self) -> Iterator[dict]:
        while True:
            sample = self.augment()
            if sample is not None:
                yield sample


class InterleaveDataset:
    """Probability mixture over datasets (`semantic.py:464-491`)."""

    def __init__(self, datasets, probabilities, seed: int = 42):
        assert len(datasets) == len(probabilities)
        self.datasets = datasets
        self.probabilities = probabilities
        self.rng = random.Random(seed)

    def __iter__(self):
        iterators = [iter(d) for d in self.datasets]
        while True:
            i = self.rng.choices(
                range(len(iterators)), weights=self.probabilities, k=1
            )[0]
            yield next(iterators[i])


@dataclass
class TextDataCollator:
    tokenizer: FishTokenizer
    max_length: int = 1024
    pad_to_max: bool = True  # static shapes: one compiled step

    def __call__(self, examples: List[dict]) -> dict:
        if self.pad_to_max:
            max_len = self.max_length
        else:
            max_len = min(
                max(e["tokens"].shape[1] for e in examples), self.max_length
            )
        eos_id = self.tokenizer.get_token_id(EOS_TOKEN)

        tokens, labels, pad_masks = [], [], []
        for example in examples:
            toks = example["tokens"][:, :max_len]
            labs = example["labels"][:, :max_len]
            t = toks.shape[1]
            pad = max_len - t
            pad_mask = np.zeros(max_len, dtype=bool)
            if pad > 0:
                pad_mask[t:] = True
                toks = np.pad(toks, ((0, 0), (0, pad)), constant_values=eos_id)
                toks[1:, t:] = CODEBOOK_PAD_TOKEN_ID
                labs = np.pad(labs, ((0, 0), (0, pad)), constant_values=IGNORE_INDEX)
            tokens.append(toks)
            labels.append(labs)
            pad_masks.append(pad_mask)

        return {
            "inputs": np.stack(tokens).astype(np.int32),
            "labels": np.stack(labels).astype(np.int32),
            "pad_mask": np.stack(pad_masks),
        }


class _ProducerError:
    """Carrier for an exception raised in the producer thread; the consumer
    re-raises it in the training loop (a plain raise would die silently in
    the daemon thread and strand the consumer on queue.get())."""

    def __init__(self, exc: BaseException):
        self.exc = exc


class DataLoader:
    """Minimal background-thread batcher over an iterable dataset."""

    def __init__(self, dataset, batch_size: int, collate_fn, prefetch: int = 2):
        self.dataset = dataset
        self.batch_size = batch_size
        self.collate_fn = collate_fn
        self.prefetch = prefetch

    def __iter__(self):
        queue: Queue = Queue(maxsize=self.prefetch)
        stop = threading.Event()

        def put(item) -> bool:
            # a plain blocking put can wedge the producer FOREVER when the
            # consumer abandons the iterator with the queue full (stop is
            # only checked between puts) — leaking the thread and its
            # prefetched batches; re-check stop while waiting instead
            while not stop.is_set():
                try:
                    queue.put(item, timeout=0.2)
                    return True
                except Full:
                    pass
            return False

        def producer():
            it = iter(self.dataset)
            try:
                while not stop.is_set():
                    batch = [next(it) for _ in range(self.batch_size)]
                    if not put(self.collate_fn(batch)):
                        return  # consumer gone; skip the sentinel too
            except StopIteration:
                pass
            except BaseException as e:  # noqa: BLE001 — a producer crash
                # (corrupt sample, collate bug) must surface in the consumer,
                # not strand it on queue.get() forever
                put(_ProducerError(e))
                return
            put(None)

        thread = threading.Thread(target=producer, daemon=True,
                                  name="dataloader-producer")
        thread.start()
        try:
            while True:
                batch = queue.get()
                if batch is None:
                    break
                if isinstance(batch, _ProducerError):
                    raise batch.exc
                yield batch
        finally:
            stop.set()


class ConcatRepeatDataset:
    """Concatenate datasets, repeating each `repeats` times before moving to
    the next (reference `datasets/concat_repeat.py`)."""

    def __init__(self, datasets, repeats: int = 1):
        self.datasets = datasets
        self.repeats = repeats

    def __iter__(self):
        while True:
            for ds in self.datasets:
                it = iter(ds)
                for _ in range(self.repeats):
                    yield next(it)
