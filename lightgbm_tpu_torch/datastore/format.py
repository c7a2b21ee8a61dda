"""The on-disk format of the shard store (the JAX package's
`datastore/format.py`, the same bytes).

A store directory holds one spilled Dataset:

    manifest.json            versioned index and checksums
    shard-00000.bins         [F, rows] C-order uint8/uint16 bin codes
    shard-00000.bundle       [G, rows] EFB-bundled codes (optional)
    shard-00000.label        [rows] float32 (optional)
    shard-00000.weight       [rows] float32 (optional)
    shard-00001.bins         ...

Every payload file has its crc32 and byte count in the manifest, and the
manifest carries a crc32 of its own canonical JSON (`manifest_crc32`),
so a truncated write, a flipped bit or a file swapped between runs is an
error before any code reaches the grower.
"""
from __future__ import annotations

import json
import os
import zlib
from typing import Any, Dict

from ..utils.log import LightGBMError

#: bump when the on-disk layout changes; readers refuse other versions
FORMAT_VERSION = 1
FORMAT_NAME = "lightgbm-tpu-datastore"
MANIFEST_NAME = "manifest.json"

#: the payloads a shard may carry, in canonical order
PAYLOADS = ("bins", "bundle", "label", "weight")


def shard_filename(index: int, payload: str) -> str:
    return f"shard-{index:05d}.{payload}"


def crc32_bytes(buf) -> int:
    """crc32 of a bytes-like object (a memoryview or mmap too)."""
    return zlib.crc32(buf) & 0xFFFFFFFF


def _canonical_dump(manifest: Dict[str, Any]) -> bytes:
    body = {k: v for k, v in manifest.items() if k != "manifest_crc32"}
    return json.dumps(body, sort_keys=True, separators=(",", ":")).encode()


def write_manifest(dirpath: str, manifest: Dict[str, Any]) -> str:
    """Write the manifest with its crc32 stamped, atomically (a temporary
    file and a rename).  `generation` counts `ShardStore.append_rows`
    rewrites: 0 for a freshly finalized store."""
    manifest = dict(manifest)
    manifest["format"] = FORMAT_NAME
    manifest["version"] = FORMAT_VERSION
    manifest.setdefault("generation", 0)
    manifest["manifest_crc32"] = crc32_bytes(_canonical_dump(manifest))
    path = os.path.join(dirpath, MANIFEST_NAME)
    tmp = path + ".tmp"
    with open(tmp, "w") as fh:
        json.dump(manifest, fh, indent=1, sort_keys=True)
        fh.write("\n")
    os.replace(tmp, path)
    return path


def read_manifest(dirpath: str) -> Dict[str, Any]:
    """The validated manifest; every failure raises `LightGBMError`
    naming the path."""
    path = os.path.join(dirpath, MANIFEST_NAME)
    try:
        with open(path) as fh:
            manifest = json.load(fh)
    except OSError as e:
        raise LightGBMError(f"datastore manifest unreadable: {path} ({e})")
    except ValueError as e:
        raise LightGBMError(f"datastore manifest corrupt (bad JSON): "
                            f"{path} ({e})")
    if not isinstance(manifest, dict) or \
            manifest.get("format") != FORMAT_NAME:
        raise LightGBMError(f"not a lightgbm_tpu datastore manifest: {path}")
    if manifest.get("version") != FORMAT_VERSION:
        raise LightGBMError(
            f"datastore format version {manifest.get('version')} is not "
            f"supported (this build reads version {FORMAT_VERSION}): {path}")
    want = manifest.get("manifest_crc32")
    got = crc32_bytes(_canonical_dump(manifest))
    if want != got:
        raise LightGBMError(
            f"datastore manifest checksum mismatch (stored {want}, "
            f"computed {got}) — the manifest was modified or truncated: "
            f"{path}")
    for key in ("dtype", "n_rows", "n_features", "shard_rows", "shards",
                "payloads"):
        if key not in manifest:
            raise LightGBMError(
                f"datastore manifest missing required field '{key}': {path}")
    return manifest


def verify_payload(dirpath: str, shard_index: int, payload: str,
                   entry: Dict[str, Any], buf) -> None:
    """Check one payload file's byte count and crc32 (`buf`, its mapped
    bytes) against its manifest entry."""
    name = os.path.join(dirpath, shard_filename(shard_index, payload))
    if len(buf) != int(entry["nbytes"]):
        raise LightGBMError(
            f"datastore shard truncated: {name} has {len(buf)} bytes, "
            f"manifest says {entry['nbytes']}")
    crc = crc32_bytes(buf)
    if crc != int(entry["crc32"]):
        raise LightGBMError(
            f"datastore shard checksum mismatch: {name} (stored "
            f"{entry['crc32']}, computed {crc}) — the file changed since it "
            "was written")
