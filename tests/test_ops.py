"""Unit tests for the compute ops, mirroring the reference's math tests
(``cpp/math/test/``, ``cpp/utils/test/``)."""

import numpy as np
import pytest
import jax.numpy as jnp

from radler_tpu.ops.peak_finder import find_peak, find_peak_with_ratio
from radler_tpu.ops.psf_subtract import shift_psf, subtract_psf_from_cube
from radler_tpu.ops.convolution import convolve_same, padded_convolve, trim, untrim
from radler_tpu.ops.noise import median_and_stddev_from_mad
from radler_tpu.ops.rms_image import (
    make_rms_factor_image,
    sliding_maximum,
    sliding_minimum,
)
from radler_tpu.ops.spectral_fitting import SpectralFitter
from radler_tpu.settings import SpectralFittingMode
from radler_tpu.utils.fft_size import calculate_good_fft_size


class TestPeakFinder:
    def test_simple(self):
        img = np.zeros((16, 16), np.float32)
        img[5, 7] = 2.0
        pk = find_peak(jnp.asarray(img), True)
        assert bool(pk.found)
        assert (int(pk.x), int(pk.y)) == (7, 5)
        assert float(pk.value) == 2.0

    def test_negative_peak_signed(self):
        img = np.zeros((16, 16), np.float32)
        img[5, 7] = -2.0
        img[3, 3] = 1.5
        pk = find_peak(jnp.asarray(img), True)
        assert float(pk.value) == -2.0
        pk = find_peak(jnp.asarray(img), False)
        assert float(pk.value) == 1.5

    def test_all_negative_disallowed(self):
        img = -np.ones((8, 8), np.float32)
        pk = find_peak(jnp.asarray(img), False)
        assert not bool(pk.found)

    def test_zero_image_not_found(self):
        pk = find_peak(jnp.zeros((8, 8), jnp.float32), True)
        assert not bool(pk.found)

    def test_border(self):
        img = np.zeros((16, 16), np.float32)
        img[0, 0] = 5.0
        img[8, 8] = 1.0
        pk = find_peak(jnp.asarray(img), True, 2, 2)
        assert (int(pk.x), int(pk.y)) == (8, 8)

    def test_border_ratio(self):
        img = np.zeros((20, 20), np.float32)
        img[1, 1] = 5.0
        img[10, 10] = 1.0
        pk = find_peak_with_ratio(jnp.asarray(img), True, 0.1)
        assert (int(pk.x), int(pk.y)) == (10, 10)

    def test_mask(self):
        img = np.zeros((8, 8), np.float32)
        img[2, 2] = 5.0
        img[4, 4] = 1.0
        mask = np.zeros((8, 8), bool)
        mask[4, 4] = True
        pk = find_peak(jnp.asarray(img), True, mask=jnp.asarray(mask))
        assert (int(pk.x), int(pk.y)) == (4, 4)


class TestPsfSubtract:
    @pytest.mark.parametrize("x,y", [(8, 8), (0, 0), (15, 15), (2, 12)])
    def test_shift_matches_reference_patch(self, x, y):
        """The shifted PSF must equal the clipped patch the reference's
        ``PartialSubtractImage`` subtracts (simple_clean.cc:61-96)."""
        rng = np.random.default_rng(0)
        n = 16
        psf = rng.normal(size=(n, n)).astype(np.float32)
        shifted = np.asarray(shift_psf(jnp.asarray(psf), x, y))
        expected = np.zeros_like(psf)
        for py in range(n):
            for px in range(n):
                sy = py - y + n // 2
                sx = px - x + n // 2
                if 0 <= sy < n and 0 <= sx < n:
                    expected[py, px] = psf[sy, sx]
        np.testing.assert_allclose(shifted, expected, atol=1e-6)

    def test_cube_subtraction(self):
        n = 16
        psf = np.zeros((1, n, n), np.float32)
        psf[0, n // 2, n // 2] = 1.0
        cube = np.zeros((2, n, n), np.float32)
        cube[:, 3, 4] = 1.0
        out = subtract_psf_from_cube(
            jnp.asarray(cube),
            jnp.asarray(psf),
            jnp.asarray([0, 0]),
            jnp.int32(4),
            jnp.int32(3),
            jnp.asarray([1.0, 0.5], jnp.float32),
        )
        out = np.asarray(out)
        np.testing.assert_allclose(out[0, 3, 4], 0.0, atol=1e-7)
        np.testing.assert_allclose(out[1, 3, 4], 0.5, atol=1e-7)


class TestConvolution:
    def test_delta_kernel_identity(self):
        rng = np.random.default_rng(1)
        img = rng.normal(size=(16, 16)).astype(np.float32)
        kernel = np.zeros((16, 16), np.float32)
        kernel[8, 8] = 1.0
        out = np.asarray(convolve_same(jnp.asarray(img), jnp.asarray(kernel)))
        np.testing.assert_allclose(out, img, atol=1e-5)

    def test_shifted_delta(self):
        img = np.zeros((16, 16), np.float32)
        img[4, 4] = 1.0
        kernel = np.zeros((16, 16), np.float32)
        kernel[9, 10] = 1.0  # center + (1, 2)
        out = np.asarray(convolve_same(jnp.asarray(img), jnp.asarray(kernel)))
        assert out[5, 6] == pytest.approx(1.0, abs=1e-5)

    def test_padded_convolve_no_wrap(self):
        # A source at the edge must not wrap around with enough padding.
        img = np.zeros((32, 32), np.float32)
        img[0, 0] = 1.0
        kernel = np.zeros((32, 32), np.float32)
        kernel[16, 16] = 1.0
        kernel[16, 18] = 0.5  # extends left by 2 when mirrored
        out = np.asarray(
            padded_convolve(jnp.asarray(img), jnp.asarray(kernel), padding=1.5)
        )
        assert out[0, 0] == pytest.approx(1.0, abs=1e-5)
        assert out[0, 2] == pytest.approx(0.5, abs=1e-5)
        # Without wrap, nothing appears on the right edge.
        assert abs(out[0, 30]) < 1e-5

    def test_trim_untrim_roundtrip(self):
        rng = np.random.default_rng(2)
        img = rng.normal(size=(8, 8)).astype(np.float32)
        padded = untrim(jnp.asarray(img), 12, 14)
        back = np.asarray(trim(padded, 8, 8))
        np.testing.assert_allclose(back, img)


class TestNoise:
    def test_median_mad(self):
        rng = np.random.default_rng(3)
        data = rng.normal(loc=1.0, scale=2.0, size=(128, 128)).astype(
            np.float32
        )
        med, sigma = median_and_stddev_from_mad(jnp.asarray(data))
        assert float(med) == pytest.approx(1.0, abs=0.1)
        assert float(sigma) == pytest.approx(2.0, abs=0.2)

    def test_nan_ignored(self):
        data = np.ones((4, 4), np.float32)
        data[0, 0] = np.nan
        med, sigma = median_and_stddev_from_mad(jnp.asarray(data))
        assert float(med) == 1.0
        assert float(sigma) == 0.0


class TestRmsImage:
    def test_sliding_minimum(self):
        img = np.arange(25, dtype=np.float32).reshape(5, 5)
        out = np.asarray(sliding_minimum(jnp.asarray(img), 3))
        assert out[2, 2] == img[1, 1]
        assert out[0, 0] == img[0, 0]

    def test_sliding_maximum(self):
        img = np.arange(25, dtype=np.float32).reshape(5, 5)
        out = np.asarray(sliding_maximum(jnp.asarray(img), 3))
        assert out[2, 2] == img[3, 3]

    def test_rms_factor(self):
        rms = jnp.asarray(np.array([[1.0, 2.0], [4.0, 1.0]], np.float32))
        factor, stddev = make_rms_factor_image(rms, 1.0)
        assert stddev == 1.0
        np.testing.assert_allclose(
            np.asarray(factor), [[1.0, 0.5], [0.25, 1.0]]
        )

    def test_rms_factor_strength_zero(self):
        rms = jnp.asarray(np.array([[1.0, 2.0]], np.float32))
        factor, _ = make_rms_factor_image(rms, 0.0)
        np.testing.assert_allclose(np.asarray(factor), 1.0)


class TestFftSize:
    def test_good_sizes(self):
        """Mirrors ``cpp/utils/test/`` FFT-size expectations: smallest even
        7-smooth number >= input."""
        assert calculate_good_fft_size(1) == 2
        assert calculate_good_fft_size(2) == 2
        assert calculate_good_fft_size(3) == 4
        assert calculate_good_fft_size(257) == 270
        assert calculate_good_fft_size(512) == 512
        for n in [100, 1000, 4097]:
            g = calculate_good_fft_size(n)
            assert g >= n and g % 2 == 0
            m = g
            for p in (2, 3, 5, 7):
                while m % p == 0:
                    m //= p
            assert m == 1


class TestSpectralFitting:
    def test_polynomial_projection(self):
        freqs = [1.0e8, 1.2e8, 1.4e8, 1.6e8]
        fitter = SpectralFitter(
            SpectralFittingMode.POLYNOMIAL, 2, freqs, [1.0] * 4
        )
        # A perfectly linear spectrum is reproduced exactly.
        x = np.asarray(freqs) / fitter.reference_frequency - 1.0
        values = (2.0 + 3.0 * x).astype(np.float32)
        fitted = np.asarray(
            fitter.fit_and_evaluate(jnp.asarray(values))
        )
        np.testing.assert_allclose(fitted, values, rtol=1e-5)
        # A noisy spectrum is smoothed to 2 terms.
        noisy = values + np.array([0.1, -0.1, 0.1, -0.1], np.float32)
        fitted = np.asarray(fitter.fit_and_evaluate(jnp.asarray(noisy)))
        coeffs = np.polyfit(x, noisy, 1)
        np.testing.assert_allclose(
            fitted, np.polyval(coeffs, x), rtol=1e-4
        )

    def test_no_fitting_identity(self):
        fitter = SpectralFitter(SpectralFittingMode.NO_FITTING, 0, [], [])
        values = jnp.asarray([1.0, 2.0])
        out = fitter.fit_and_evaluate(values)
        np.testing.assert_allclose(np.asarray(out), [1.0, 2.0])

    def test_log_polynomial_power_law(self):
        freqs = [1.0e8, 1.25e8, 1.5e8, 2.0e8]
        fitter = SpectralFitter(
            SpectralFittingMode.LOG_POLYNOMIAL, 2, freqs, [1.0] * 4
        )
        ref = fitter.reference_frequency
        values = (2.0 * (np.asarray(freqs) / ref) ** -0.7).astype(np.float32)
        fitted = np.asarray(fitter.fit_and_evaluate(jnp.asarray(values)))
        np.testing.assert_allclose(fitted, values, rtol=1e-4)
        terms = fitter.fit(values)
        assert terms[0] == pytest.approx(2.0, rel=1e-3)
        assert terms[1] == pytest.approx(-0.7, rel=1e-3)

    def test_fit_image_roundtrip(self):
        freqs = [1.0e8, 1.2e8, 1.4e8]
        fitter = SpectralFitter(
            SpectralFittingMode.POLYNOMIAL, 2, freqs, [1.0] * 3
        )
        rng = np.random.default_rng(0)
        spectra = rng.normal(size=(3, 4, 4)).astype(np.float32)
        terms = fitter.fit_image(jnp.asarray(spectra))
        out = np.asarray(fitter.evaluate_image(terms, freqs[1]))
        assert out.shape == (4, 4)


class TestComponentOptimization:
    """Mirrors ``cpp/math/test/test_component_optimization.cc`` scenarios."""

    def _problem(self):
        size = 32
        psf = np.zeros((size, size), np.float32)
        psf[size // 2, size // 2] = 1.0
        psf[size // 2, size // 2 + 1] = 0.3
        psf[size // 2 + 1, size // 2] = 0.2
        model_true = np.zeros((size, size), np.float32)
        model_true[10, 10] = 2.0
        model_true[20, 25] = -1.0
        from radler_tpu.ops.convolution import padded_convolve

        dirty = np.asarray(
            padded_convolve(jnp.asarray(model_true), jnp.asarray(psf))
        )
        return size, psf, model_true, dirty

    def test_linear_solve_exact(self):
        from radler_tpu.ops.component_optimization import (
            linear_component_solve,
        )

        size, psf, model_true, dirty = self._problem()
        seed = (jnp.asarray(model_true != 0)).astype(jnp.float32) * 1e-30
        model, residual = linear_component_solve(
            seed, jnp.asarray(dirty), jnp.asarray(psf)
        )
        np.testing.assert_allclose(
            np.asarray(model)[10, 10], 2.0, atol=1e-4
        )
        np.testing.assert_allclose(
            np.asarray(model)[20, 25], -1.0, atol=1e-4
        )
        # Residual is zeroed at component positions (the solver's contract,
        # component_optimization.cc:181-263).
        assert abs(np.asarray(residual)[10, 10]) < 1e-5

    def test_gradient_descent_reduces_rms(self):
        from radler_tpu.ops.component_optimization import gradient_descent

        size, psf, model_true, dirty = self._problem()
        support = jnp.asarray((model_true != 0).astype(np.float32))
        model, residual = gradient_descent(
            jnp.zeros((size, size), jnp.float32),
            jnp.asarray(dirty),
            jnp.asarray(psf),
            support_mask=support,
        )
        rms_before = float(np.sqrt((dirty**2).mean()))
        rms_after = float(jnp.sqrt(jnp.mean(residual**2)))
        assert rms_after < 0.1 * rms_before
        assert np.asarray(model)[10, 10] == pytest.approx(2.0, rel=0.05)

    def test_variable_psf_joint_fit(self):
        from radler_tpu.ops.component_optimization import (
            gradient_descent_with_variable_psf,
            padded_convolve,
        )

        size = 32
        psf_a = np.zeros((size, size), np.float32)
        psf_a[size // 2, size // 2] = 1.0
        psf_b = np.zeros((size, size), np.float32)
        psf_b[size // 2, size // 2] = 1.0
        psf_b[size // 2, size // 2 + 1] = 0.5
        model_a = np.zeros((size, size), np.float32)
        model_a[8, 8] = 1.5
        model_b = np.zeros((size, size), np.float32)
        model_b[22, 20] = 0.7
        dirty = np.asarray(
            padded_convolve(jnp.asarray(model_a), jnp.asarray(psf_a))
            + padded_convolve(jnp.asarray(model_b), jnp.asarray(psf_b))
        )
        supports = [
            jnp.asarray((model_a != 0).astype(np.float32)),
            jnp.asarray((model_b != 0).astype(np.float32)),
        ]
        deltas = gradient_descent_with_variable_psf(
            supports, jnp.asarray(dirty), [jnp.asarray(psf_a), jnp.asarray(psf_b)]
        )
        assert np.asarray(deltas[0])[8, 8] == pytest.approx(1.5, rel=0.05)
        assert np.asarray(deltas[1])[22, 20] == pytest.approx(0.7, rel=0.1)
