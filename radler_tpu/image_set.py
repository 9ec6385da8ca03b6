"""The working image cube for one deconvolution run.

Behavioral equivalent of the reference's ``ImageSet``
(``cpp/image_set.{h,cc}``), redesigned TPU-first: the cube is a single
``[n_images, H, W]`` float32 JAX array (``n_images = n_deconvolution_channels
* n_polarizations``, channel-major, matching ``cpp/image_set.cc:69-96``), and
the joined-channel / joined-polarization integration math
(``cpp/image_set.cc:309-462``) becomes a couple of fused reductions that XLA
compiles into single device-memory passes.

Static per-run metadata (channel weights, linked-polarization flags, the
polarization normalization factor) lives in :class:`CubeMeta`, a hashable
NamedTuple so jitted functions can close over it.
"""

from __future__ import annotations

import dataclasses
from typing import List, NamedTuple, Sequence, Set, Tuple

import numpy as np
import jax
import jax.numpy as jnp

from .settings import (
    Polarization,
    has_dual_polarization,
    has_full_circular_polarization,
    has_full_linear_polarization,
)
from .work_table import WorkTable


class CubeMeta(NamedTuple):
    """Static description of an image cube; hashable for jit closures."""

    n_channels: int  # number of deconvolution channels
    n_polarizations: int
    weights: Tuple[float, ...]  # per deconvolution channel
    linked: Tuple[bool, ...]  # per polarization slot: participates in joins
    polarization_norm_factor: float
    squared_joins: bool
    frequencies: Tuple[float, ...]  # per deconvolution channel (Hz)

    @property
    def n_images(self) -> int:
        return self.n_channels * self.n_polarizations

    def psf_index(self, image_index: int) -> int:
        """Deconvolution-channel (= PSF) index of a cube plane
        (``cpp/image_set.cc:87-95``)."""
        return image_index // self.n_polarizations

    @property
    def psf_indices(self) -> np.ndarray:
        return np.arange(self.n_images) // self.n_polarizations


def compute_polarization_norm_factor(
    polarizations: Sequence[Polarization],
    linked_polarizations: Set[Polarization],
) -> float:
    """Normalization for joined-polarization integration.

    Rules mirror ``cpp/image_set.h:298-324``: 1/n for all-Stokes-without-I,
    0.5 for dual (XX+YY / RR+LL) or full linear/circular sets, else 1.0.
    """
    pols: Set[Polarization] = set()
    all_stokes_without_i = True
    for pol in polarizations:
        if not linked_polarizations or pol in linked_polarizations:
            if not pol.is_stokes or pol == Polarization.STOKES_I:
                all_stokes_without_i = False
            pols.add(pol)
    is_dual = len(pols) == 2 and has_dual_polarization(pols)
    is_full = len(pols) == 4 and (
        has_full_linear_polarization(pols) or has_full_circular_polarization(pols)
    )
    if all_stokes_without_i:
        return 1.0 / len(pols)
    if is_dual or is_full:
        return 0.5
    return 1.0


def calculate_deconvolution_frequencies(
    table: WorkTable,
) -> Tuple[np.ndarray, np.ndarray]:
    """Weighted central frequency and weight of each deconvolution channel.

    Mirrors ``cpp/image_set.cc:464-497`` including the zero-weight fallback to
    the unweighted mean frequency.
    Returns (frequencies[n_deconv], weights[n_deconv]).
    """
    n_input = len(table.original_groups)
    n_deconv = len(table.deconvolution_groups)
    frequencies = np.zeros(n_deconv, dtype=np.float64)
    weights = np.zeros(n_deconv, dtype=np.float64)
    unweighted = np.zeros(n_deconv, dtype=np.float64)
    counts = np.zeros(n_deconv, dtype=np.int64)
    for i in range(n_input):
        entry = table.original_groups[i][0]
        freq = entry.central_frequency
        weight = entry.image_weight
        dc = i * n_deconv // n_input
        frequencies[dc] += freq * weight
        weights[dc] += weight
        unweighted[dc] += freq
        counts[dc] += 1
    for i in range(n_deconv):
        if weights[i] > 0.0:
            frequencies[i] /= weights[i]
        else:
            frequencies[i] = unweighted[i] / counts[i]
    return frequencies, weights.astype(np.float32)


# ---------------------------------------------------------------------------
# Integration math (pure, jit-friendly)
# ---------------------------------------------------------------------------


def _linked_mask(meta: CubeMeta) -> np.ndarray:
    return np.asarray(meta.linked, dtype=np.float32)


def linear_integration_coefficients(meta: CubeMeta) -> np.ndarray:
    """Per-plane coefficients such that the linear integration is a single
    weighted sum over the cube (``cpp/image_set.cc:423-462``)."""
    w = np.asarray(meta.weights, dtype=np.float64)
    linked = _linked_mask(meta).astype(np.float64)
    weight_sum = w.sum()
    if weight_sum > 0.0:
        per_chan = w * meta.polarization_norm_factor / weight_sum
    else:
        per_chan = np.zeros_like(w)
    coefs = np.einsum("c,p->cp", per_chan, linked).reshape(-1)
    return coefs.astype(np.float32)


def get_linear_integrated(data: jnp.ndarray, meta: CubeMeta) -> jnp.ndarray:
    """Weighted linear average over channels & linked polarizations.

    Equivalent of ``ImageSet::GetLinearIntegrated`` (``cpp/image_set.h:150-155``):
    falls back to the squared-channels integration when ``squared_joins``.
    """
    if meta.squared_joins:
        return _square_integrated_squared_channels(data, meta)
    if meta.n_images == 1:
        return data[0]
    coefs = jnp.asarray(linear_integration_coefficients(meta))
    return jnp.einsum("i,ihw->hw", coefs, data)


def get_square_integrated(data: jnp.ndarray, meta: CubeMeta) -> jnp.ndarray:
    """sqrt-of-sum-of-squares over linked pols, weighted over channels.

    Equivalent of ``ImageSet::GetSquareIntegrated``
    (``cpp/image_set.cc:309-421``).
    """
    if meta.squared_joins:
        return _square_integrated_squared_channels(data, meta)
    return _square_integrated_normal_channels(data, meta)


def _square_integrated_normal_channels(
    data: jnp.ndarray, meta: CubeMeta
) -> jnp.ndarray:
    """``cpp/image_set.cc:309-385``."""
    C, P = meta.n_channels, meta.n_polarizations
    H, W = data.shape[-2:]
    cube = data.reshape(C, P, H, W)
    linked = jnp.asarray(_linked_mask(meta))
    n_linked = int(_linked_mask(meta).sum())
    if C == 1:
        if P == 1:
            return data[0]
        sq = jnp.einsum("p,phw->hw", linked, cube[0] * cube[0])
        return jnp.sqrt(sq) * np.float32(
            np.sqrt(meta.polarization_norm_factor)
        )
    w = np.asarray(meta.weights, dtype=np.float64)
    weight_sum = w[w != 0].sum()
    if weight_sum == 0.0:
        return jnp.zeros((H, W), dtype=data.dtype)
    if P == 1:
        per_chan = cube[:, 0]
    elif n_linked == 0:
        per_chan = jnp.zeros((C, H, W), dtype=data.dtype)
    else:
        per_chan = jnp.sqrt(jnp.einsum("p,cphw->chw", linked, cube * cube))
    wj = jnp.asarray(w.astype(np.float32))
    dest = jnp.einsum("c,chw->hw", wj, per_chan)
    return dest * np.float32(
        np.sqrt(meta.polarization_norm_factor) / weight_sum
    )


def _square_integrated_squared_channels(
    data: jnp.ndarray, meta: CubeMeta
) -> jnp.ndarray:
    """``cpp/image_set.cc:387-421``: sqrt of the weighted mean square."""
    C, P = meta.n_channels, meta.n_polarizations
    H, W = data.shape[-2:]
    cube = data.reshape(C, P, H, W)
    linked = jnp.asarray(_linked_mask(meta))
    w = np.asarray(meta.weights, dtype=np.float64)
    weight_sum = w[w != 0].sum()
    if weight_sum == 0.0:
        return jnp.zeros((H, W), dtype=data.dtype)
    wj = jnp.asarray(w.astype(np.float32))
    sq = jnp.einsum("c,p,cphw->hw", wj, linked, cube * cube)
    return jnp.sqrt(sq) * np.float32(
        np.sqrt(meta.polarization_norm_factor / weight_sum)
    )


def get_integrated_psf(psfs: jnp.ndarray, meta: CubeMeta) -> jnp.ndarray:
    """Channel-weighted average PSF (``cpp/image_set.cc:499-530``).

    ``psfs`` is ``[n_channels, h, w]``.
    """
    if meta.n_channels == 1:
        return psfs[0]
    w = np.asarray(meta.weights, dtype=np.float64)
    weight_sum = w[w != 0].sum()
    factor = 0.0 if weight_sum == 0.0 else 1.0 / weight_sum
    wj = jnp.asarray((w * factor).astype(np.float32))
    return jnp.einsum("c,chw->hw", wj, psfs)


# ---------------------------------------------------------------------------
# The ImageSet container
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class ImageSet:
    """Owns the cube for one run plus host-side load/store plumbing.

    ``data`` is a ``[n_images, H, W]`` float32 jnp array.  Algorithms operate
    on ``data`` functionally (they return updated arrays); this class handles
    the accessor I/O boundary (``LoadAndAverage`` / store-back) and carries
    the static :class:`CubeMeta`.
    """

    table: WorkTable
    meta: CubeMeta
    data: jnp.ndarray
    # entry index -> cube plane index (``cpp/image_set.cc:69-85``)
    entry_to_image: np.ndarray

    # -- construction ------------------------------------------------------
    @classmethod
    def from_table(
        cls,
        table: WorkTable,
        squared_joins: bool,
        linked_polarizations: Set[Polarization],
        width: int,
        height: int,
    ) -> "ImageSet":
        first_group = table.original_groups[0]
        n_pol = len(first_group)
        n_chan = len(table.deconvolution_groups)
        pols = [e.polarization for e in first_group]
        pol_norm = compute_polarization_norm_factor(pols, linked_polarizations)
        linked = tuple(
            (not linked_polarizations) or (p in linked_polarizations) for p in pols
        )
        frequencies, weights = calculate_deconvolution_frequencies(table)
        meta = CubeMeta(
            n_channels=n_chan,
            n_polarizations=n_pol,
            weights=tuple(float(v) for v in weights),
            linked=linked,
            polarization_norm_factor=float(pol_norm),
            squared_joins=squared_joins,
            frequencies=tuple(float(f) for f in frequencies),
        )
        entry_to_image = cls._compute_entry_to_image(table)
        data = jnp.zeros((n_chan * n_pol, height, width), dtype=jnp.float32)
        return cls(table=table, meta=meta, data=data, entry_to_image=entry_to_image)

    @staticmethod
    def _compute_entry_to_image(table: WorkTable) -> np.ndarray:
        """``cpp/image_set.cc:69-85``: entries of original groups inside the
        same deconvolution group map onto the same cube planes."""
        entry_to_image = np.zeros(table.size, dtype=np.int64)
        image_index = 0
        for group in table.deconvolution_groups:
            start = image_index
            for original_index in group:
                image_index = start
                for entry in table.original_groups[original_index]:
                    entry_to_image[entry.index] = image_index
                    image_index += 1
        return entry_to_image

    def clone_shape(self, width: int, height: int) -> "ImageSet":
        """New zeroed ImageSet with identical configuration but a different
        image size (``cpp/image_set.h:25-33``)."""
        data = jnp.zeros(
            (self.meta.n_images, height, width), dtype=jnp.float32
        )
        return ImageSet(
            table=self.table,
            meta=self.meta,
            data=data,
            entry_to_image=self.entry_to_image,
        )

    # -- shape helpers -----------------------------------------------------
    @property
    def width(self) -> int:
        return self.data.shape[-1]

    @property
    def height(self) -> int:
        return self.data.shape[-2]

    @property
    def n_images(self) -> int:
        return self.meta.n_images

    def __len__(self) -> int:
        return self.meta.n_images

    def __getitem__(self, index: int) -> jnp.ndarray:
        return self.data[index]

    def psf_index(self, image_index: int) -> int:
        return self.meta.psf_index(image_index)

    # -- host I/O boundary -------------------------------------------------
    def load_and_average(self, use_residual_images: bool) -> None:
        """Load caller images, averaging original channels into deconvolution
        channels with image weights (``cpp/image_set.cc:105-140``)."""
        H, W = self.height, self.width
        per_index = [[] for _ in range(self.n_images)]
        weight_acc = np.zeros(self.n_images, dtype=np.float64)
        for entry in self.table:
            if entry.image_weight == 0.0:
                # Zero-weight images may contain NaNs; skip them.
                continue
            accessor = (
                entry.residual_accessor
                if use_residual_images
                else entry.model_accessor
            )
            image_index = self.entry_to_image[entry.index]
            per_index[image_index].append((accessor.load(), entry.image_weight))
            weight_acc[image_index] += entry.image_weight
        # Accumulate on device so device-resident accessors incur no host
        # round-trip; NumPy-backed accessors are transferred once each.
        planes = []
        for image_index in range(self.n_images):
            total = weight_acc[image_index]
            acc = None
            for array, weight in per_index[image_index]:
                term = jnp.asarray(array, jnp.float32) * np.float32(
                    weight / total
                )
                acc = term if acc is None else acc + term
            if acc is None:
                # Zero total weight: the reference's 1/0 scaling makes such
                # planes non-finite and every integration then skips them via
                # their zero weight.  A zero-filled plane gives the same
                # integration results without poisoning whole-cube reductions
                # (0 * NaN = NaN would break the joined peak search).
                acc = jnp.zeros((H, W), jnp.float32)
            planes.append(acc)
        self.data = jnp.stack(planes)

    def load_and_average_psfs(self) -> List[jnp.ndarray]:
        """Per direction-dependent PSF index, the channel-averaged PSF stack.

        Returns ``result[dd_psf_index]`` of shape ``[n_channels, h, w]``; the
        X/Y swap relative to the work-table layout mirrors
        ``cpp/image_set.cc:142-207``.
        """
        first_psf_accessors = self.table.front.psf_accessors
        n_deconv = self.meta.n_channels
        n_orig = len(self.table.original_groups)
        result: List[jnp.ndarray] = []
        for psf_index, first_acc in enumerate(first_psf_accessors):
            ph, pw = first_acc.height, first_acc.width
            weight_acc = np.zeros(n_deconv, dtype=np.float64)
            for group_index in range(n_orig):
                channel_index = group_index * n_deconv // n_orig
                entry = self.table.original_groups[group_index][0]
                weight_acc[channel_index] += entry.image_weight
            planes = [None] * n_deconv
            for group_index in range(n_orig):
                channel_index = group_index * n_deconv // n_orig
                entry = self.table.original_groups[group_index][0]
                total = weight_acc[channel_index]
                factor = (
                    0.0 if total == 0.0 else entry.image_weight / total
                )
                term = jnp.asarray(
                    entry.psf_accessors[psf_index].load(), jnp.float32
                ) * np.float32(factor)
                planes[channel_index] = (
                    term
                    if planes[channel_index] is None
                    else planes[channel_index] + term
                )
            for channel_index in range(n_deconv):
                if planes[channel_index] is None:
                    planes[channel_index] = jnp.zeros((ph, pw), jnp.float32)
            result.append(jnp.stack(planes))
        return result

    def assign_and_store_residual(self) -> None:
        """Write deconvolution-channel residuals back to every original
        entry (``cpp/image_set.cc:290-307``).  Device-resident accessors
        receive the on-device plane; NumPy accessors share one bulk
        device-to-host transfer."""
        from .work_table import DeviceImageAccessor

        host = None
        for entry in self.table:
            accessor = entry.residual_accessor
            index = self.entry_to_image[entry.index]
            if isinstance(accessor, DeviceImageAccessor):
                accessor.store(self.data[index])
            else:
                if host is None:
                    host = np.asarray(self.data)
                accessor.store(host[index])

    def interpolate_and_store_model(self, fitter) -> None:
        """Store the model; when deconvolution channels < original channels,
        interpolate each pixel's spectrum through the spectral fitter
        (``cpp/image_set.cc:209-288``).

        ``fitter`` is a :class:`radler_tpu.ops.spectral_fitting.SpectralFitter`.
        """
        from .work_table import DeviceImageAccessor

        n_orig = len(self.table.original_groups)
        n_deconv = self.meta.n_channels
        if n_deconv == n_orig:
            # Device-resident accessors receive the on-device plane (no
            # host round trip for a full cube); NumPy accessors share one bulk
            # transfer, like assign_and_store_residual.
            host = None
            for image_index, entry in enumerate(self.table):
                accessor = entry.model_accessor
                if isinstance(accessor, DeviceImageAccessor):
                    accessor.store(self.data[image_index])
                else:
                    if host is None:
                        host = np.asarray(self.data)
                    accessor.store(host[image_index])
            return

        first_group = self.table.original_groups[0]
        n_pol = self.meta.n_polarizations
        C, H, W = n_deconv, self.height, self.width
        cube = self.data.reshape(C, n_pol, H, W)
        for pol_index in range(n_pol):
            pol = first_group[pol_index].polarization
            spectra = cube[:, pol_index]  # [C, H, W]
            # Fit spectral terms for every pixel at once (vmapped lstsq),
            # then evaluate at each output-channel frequency. Zero pixels
            # stay zero, matching cpp/image_set.cc:246-263.
            terms = fitter.fit_image(spectra)  # [n_terms, H, W]
            for entry in self.table.get_original_same_polarization_group(pol):
                out = fitter.evaluate_image(terms, entry.central_frequency)
                accessor = entry.model_accessor
                if isinstance(accessor, DeviceImageAccessor):
                    accessor.store(out)
                else:
                    accessor.store(np.asarray(out))

    # -- facet helpers (used by the parallel layer) ------------------------
    def trim(self, x1: int, y1: int, x2: int, y2: int) -> "ImageSet":
        """Sub-image copy (``cpp/image_set.h:216-223``)."""
        out = self.clone_shape(x2 - x1, y2 - y1)
        out.data = self.data[:, y1:y2, x1:x2]
        return out

    def trim_masked(
        self, x1: int, y1: int, x2: int, y2: int, mask: np.ndarray
    ) -> "ImageSet":
        """Masked sub-image copy (``cpp/image_set.h:230-240``)."""
        out = self.trim(x1, y1, x2, y2)
        out.data = out.data * jnp.asarray(mask, dtype=out.data.dtype)
        return out

    def copy_masked(
        self, source: "ImageSet", to_x: int, to_y: int, mask: np.ndarray
    ) -> None:
        """Copy masked pixels of ``source`` into this set at an offset
        (``cpp/image_set.h:242-250``)."""
        h, w = source.height, source.width
        region = jax.lax.dynamic_slice(
            self.data, (0, to_y, to_x), (self.n_images, h, w)
        )
        m = jnp.asarray(mask, dtype=bool)
        merged = jnp.where(m[None, :, :], source.data, region)
        self.data = jax.lax.dynamic_update_slice(self.data, merged, (0, to_y, to_x))

    def add_sub_image(self, source: "ImageSet", to_x: int, to_y: int) -> None:
        """Add a smaller ImageSet onto this one (``cpp/image_set.h:252-264``)."""
        h, w = source.height, source.width
        region = jax.lax.dynamic_slice(
            self.data, (0, to_y, to_x), (self.n_images, h, w)
        )
        self.data = jax.lax.dynamic_update_slice(
            self.data, region + source.data, (0, to_y, to_x)
        )

    # -- integration wrappers ---------------------------------------------
    def get_linear_integrated(self) -> jnp.ndarray:
        return get_linear_integrated(self.data, self.meta)

    def get_square_integrated(self) -> jnp.ndarray:
        return get_square_integrated(self.data, self.meta)

    def get_integrated_psf(self, psfs: jnp.ndarray) -> jnp.ndarray:
        return get_integrated_psf(psfs, self.meta)
