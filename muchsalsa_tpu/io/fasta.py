"""FASTA/FASTQ ingest and random access.

Reference counterpart: ``SequenceAccessor`` (``libms/src/SequenceAccessor.cpp``),
which builds per-record (offset, length) indexes and re-reads from disk
under a mutex on every access.  This design instead loads each
record once into contiguous host memory (bytes), because consensus reads
sequences many times per base and the target genomes (<= a few hundred Mb)
fit host RAM comfortably; an offset-index + mmap mode can be layered in
for out-of-core inputs.

Parity details preserved:
- FASTQ detection is *extension-based*: anything not ending ``.fa`` /
  ``.fasta`` is FASTQ (``SequenceAccessor.cpp:71-78``).
- record ids are the description line up to the first whitespace
  (``cleanSequenceId``).
- whitespace inside sequence lines is stripped.
"""

from __future__ import annotations

from pathlib import Path

from muchsalsa_tpu.io.registry import Registry


def is_fastq(path: str | Path) -> bool:
    ext = str(path).rsplit(".", 1)[-1].lower()
    return ext not in ("fa", "fasta")


def _iter_fasta(data: bytes):
    pos = data.find(b">")
    if pos < 0:
        return
    while pos >= 0:
        header_end = data.find(b"\n", pos)
        if header_end < 0:
            return
        header = data[pos + 1 : header_end]
        nxt = data.find(b"\n>", header_end)
        body_end = len(data) if nxt < 0 else nxt + 1
        body = data[header_end + 1 : body_end]
        yield header, b"".join(body.split())
        pos = -1 if nxt < 0 else nxt + 1


def _iter_fastq(data: bytes):
    lines = data.split(b"\n")
    i = 0
    n = len(lines)
    while i + 1 < n:
        header = lines[i]
        if not header.startswith(b"@"):
            i += 1
            continue
        seq = lines[i + 1]
        yield header[1:], b"".join(seq.split())
        i += 4


def _clean_id(header: bytes) -> str:
    return header.split()[0].decode() if header.split() else ""


class SequenceStore:
    """In-memory random-access sequence store keyed by dense registry ids."""

    def __init__(self, registry: Registry | None = None) -> None:
        self.registry = registry if registry is not None else Registry()
        self._seqs: dict[int, bytes] = {}
        self._descriptions: dict[int, str] = {}
        self._str_cache: dict[int, str] = {}
        # bumped on every mutation: device-side packed-batch caches key
        # on this so a post-mapping add() can't serve stale batches
        self.version: int = 0

    @staticmethod
    def from_file(path: str | Path, registry: Registry | None = None) -> "SequenceStore":
        store = SequenceStore(registry)
        store.load(path)
        return store

    def load(self, path: str | Path, use_native: bool = True) -> None:
        data = Path(path).read_bytes()
        fastq = is_fastq(path)

        if use_native:
            from muchsalsa_tpu import native

            if native.available():
                parsed = native.parse_fasta(data, fastq)
                if parsed is not None:
                    names, blob, offsets = parsed
                    for i, name in enumerate(names):
                        idx = self.registry[name]
                        self._seqs[idx] = blob[offsets[i] : offsets[i + 1]]
                        self._descriptions[idx] = name
                    self.version += 1
                    return

        it = _iter_fastq(data) if fastq else _iter_fasta(data)
        for header, seq in it:
            rec_id = _clean_id(header)
            idx = self.registry[rec_id]
            self._seqs[idx] = seq
            self._descriptions[idx] = header.decode(errors="replace")
        self.version += 1

    def add(self, name: str, seq: bytes | str) -> int:
        idx = self.registry[name]
        self._seqs[idx] = seq.encode() if isinstance(seq, str) else bytes(seq)
        self._descriptions[idx] = name
        self._str_cache.pop(idx, None)
        self.version += 1
        return idx

    def __len__(self) -> int:
        return len(self._seqs)

    def __contains__(self, idx: int) -> bool:
        return idx in self._seqs

    def sequence(self, idx: int) -> bytes:
        return self._seqs[idx]

    def sequence_str(self, idx: int) -> str:
        # consensus fetches sub-ranges of the same read many times;
        # cache the decoded string (decode is O(len) per call otherwise)
        s = self._str_cache.get(idx)
        if s is None:
            s = self._seqs[idx].decode()
            self._str_cache[idx] = s
        return s

    def length(self, idx: int) -> int:
        return len(self._seqs[idx])

    def description(self, idx: int) -> str:
        return self._descriptions[idx]

    def ids(self) -> list[int]:
        return sorted(self._seqs)

    def items(self):
        for idx in self.ids():
            yield idx, self._seqs[idx]


def write_fasta(path: str | Path, records, width: int = 60) -> None:
    """Write ``(name, sequence)`` pairs as wrapped FASTA."""
    with open(path, "w") as fh:
        for name, seq in records:
            if isinstance(seq, bytes):
                seq = seq.decode()
            fh.write(f">{name}\n")
            for i in range(0, len(seq), width):
                fh.write(seq[i : i + width] + "\n")
