"""The train CLI's input feed, shared by both backends (the reference's
``train.py:831-902``, ``:1404-1475`` and ``:1596-1612``).

- :func:`feed_error`: the reference's refusals of ``--native-wire`` and
  ``--native-loader``, each an ``error: ...`` line for exit code 2: u8
  without the ring, a config without a native path, a config without a
  u8 path, and a native library that cannot be built or loaded.
- :func:`apply_native_wire`: resolves ``--native-wire`` (unset: u8 for an
  image config with the ring, else f32) and sets the ring's wire. An image
  config's loss dequants a u8 ``image`` on the device, inside the step
  (``configs._dequanting``).
- :func:`round_feed`: the round loop's batches: the ring's or the Python
  loader's, each rank's rows on the collective backend (``rank=``),
  through a :class:`~consensusml_tpu_torch.data.prefetch.DevicePrefetcher`
  onto the step's device at ``--prefetch-depth`` (0: none). On the
  simulated backend an image ring hands its slots out zero-copy (views
  released once their copy to the device has completed); a collective
  rank copies its rows out of each slot, as the reference's processes
  take host batches.
"""

from __future__ import annotations

import dataclasses

__all__ = ["feed_error", "apply_native_wire", "round_feed", "feed_text"]


def feed_error(bundle, native_loader: bool, native_wire: str | None) -> str | None:
    """The reference's refusal of the feed flags, or None."""
    if native_wire == "u8":
        if not native_loader:
            return "error: --native-wire u8 requires --native-loader"
        if bundle.native_batches is None:
            return f"error: config {bundle.name} has no native loader path"
        if not bundle.native_batches.supports_wire:
            return f"error: config {bundle.name} has no u8-wire native path (image workloads only)"
    if native_loader:
        from consensusml_tpu_torch import native

        if bundle.native_batches is None:
            return f"error: config {bundle.name} has no native loader path"
        if not native.available():
            return ("error: --native-loader requested but the native library is unavailable (see "
                    f"consensusml_tpu_torch.native)\n{native.load_error()}")
    return None


def apply_native_wire(bundle, native_loader: bool, native_wire: str | None) -> tuple[str, str]:
    """Resolve the wire and set it on the bundle's ring. Returns ``(wire,
    why)``, the reference's ``native wire:`` line's parts. Call after
    :func:`feed_error`."""
    source = bundle.native_batches
    wire_supported = source is not None and source.supports_wire
    wire = native_wire or ("u8" if native_loader and wire_supported else "f32")
    why = "explicit" if native_wire else (
        "auto: image config, --native-wire f32 overrides" if wire == "u8" else "auto: config has no u8 path")
    if native_loader and wire_supported:
        bundle.native_batches = dataclasses.replace(source, wire=wire)
    return wire, why


def round_feed(bundle, spec: dict, rounds: int, start: int, device, rank: int | None = None):
    """The round loop's iterable of batches on ``device`` (``spec``: the
    parsed flags as a dict). ``rank``: a collective rank's rows only."""
    from consensusml_tpu_torch.data.prefetch import prefetch_to_device
    from consensusml_tpu_torch.train.local_sgd import rank_batch

    depth = int(spec.get("prefetch_depth", 2))
    native = spec.get("native_loader")
    batch_source = bundle.native_batches if native else bundle.batches
    if depth > 0 and rank is None and native and batch_source.supports_views:
        # the prefetch window sizes the ring too: each copy in flight pins a slot
        source = batch_source(rounds, spec["seed"], start, views=True, prefetch=depth)
    else:
        source = batch_source(rounds, spec["seed"], start)
    if rank is not None:
        source = (rank_batch(b, rank) for b in source)
    return prefetch_to_device(source, depth, device=device)


def feed_text(feed) -> str | None:
    """The reference's end-of-run ``feed:`` line, when a prefetcher ran."""
    from consensusml_tpu_torch.data.prefetch import DevicePrefetcher

    if not isinstance(feed, DevicePrefetcher) or not feed.batches_out:
        return None
    return (f"feed: {feed.batches_out} rounds prefetched, stall {feed.stall_seconds_total:.3f}s total "
            f"({1e3 * feed.last_stall_s:.1f} ms last round)")
