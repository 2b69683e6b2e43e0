"""Experiment: ONE-STEP exact mixing estimator (Tse-Wan style).

ADR-008's addendum leaves exactly one bias direction standing: closed-form
conditional moments of IV = ∫V | (V0, V_T) with Bessel-ratio terms.  Taken
to its logical end the time loop disappears entirely for European pricing:

  1. V_T ~ exact CIR transition (noncentral chi-square, Poisson-Gamma mix)
  2. IV | V0,V_T ~ moment-matched family (IG / lognormal / gamma) with the
     EXACT conditional mean m1 and variance s2 from the Broadie-Kaya
     Laplace transform (reference src/distributions/heston.jl:150-212)
  3. J = (V_T - V0 - kappa*theta*T + kappa*IV)/sigma   (CIR identity)
  4. payoff = conditional Black-Scholes in (IV, J)     (Romano-Touzi)

Bias then comes ONLY from the 2-moment family approximation of IV|endpoints
(Tse-Wan 2013 report sub-bp for IG).  This script measures that bias on the
ADR-008 market grid with a 3-D Sobol' stream (y via ncx2.ppf, IV via the
IG transform) so se << 1bp at 2^20 points.

Moment formulas: differentiate log Phi(a) of Broadie-Kaya eq. (14) at a=0
through gamma(a) = sqrt(kappa^2 + 2 sigma^2 a).  With D=T, t2 = kappa*D/2,
c1 = coth(t2), c2 = csch^2(t2), z = (2 sqrt(x y)/sigma^2) kappa/sinh(t2),
W = z * d/dz log I_nu(z) = z*I_{nu+1}(z)/I_nu(z) + nu:

  l1 = 1/kappa - (D/2) c1 - ((x+y)/sigma^2)(c1 - t2 c2) + W q
  l2 = -1/kappa^2 + (D^2/4) c2 + ((x+y)/sigma^2)(D c2 - kappa (D^2/2) c2 c1)
       + (z^2 + nu^2 - W - W^2) q^2 + W p
  q  = (1 - t2 c1)/kappa,     p = zpp/z = -(D/kappa) c1 + (D^2/4)(c1^2 + c2)
  m1 = -(sigma^2/kappa) l1
  s2 = -(sigma^4/kappa^3) l1 + (sigma^4/kappa^2) l2

Usage: python benchmarks/one_step_exact_mixing.py   (CPU, scipy)
"""

import datetime as dt
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np
from scipy import special, stats

REF = dt.date(2024, 1, 1)
EXPIRY = dt.date(2025, 1, 1)
R, SPOT, STRIKE = 0.03, 100.0, 100.0

MARKETS = {
    "bench":   dict(kappa=2.0, theta=0.04, sigma=0.3, rho=-0.7, V0=0.04),
    "feller":  dict(kappa=1.0, theta=0.06, sigma=0.5, rho=-0.8, V0=0.04),
    "fast-mr": dict(kappa=3.0, theta=0.04, sigma=0.4, rho=-0.5, V0=0.09),
    "slow-mr": dict(kappa=0.5, theta=0.08, sigma=0.25, rho=-0.3, V0=0.02),
}


def iv_cond_moments(x, y, kappa, theta, sigma, T, use_cf=False):
    """Exact conditional mean/variance of int_0^T V dt given V_0=x, V_T=y."""
    nu = 2.0 * kappa * theta / sigma**2 - 1.0
    t2 = kappa * T / 2.0
    s = np.sinh(t2)
    c1 = np.cosh(t2) / s
    c2 = 1.0 / s**2
    z = (2.0 * np.sqrt(x * y) / sigma**2) * kappa / s
    # W = z * dlogI_nu/dz, via the scaled ratio (stable for all z >= 0)
    if use_cf:
        ratio = bessel_ratio_cf(nu, z)
    else:
        ratio = special.ive(nu + 1.0, z) / special.ive(nu, z)
    W = z * ratio + nu
    q = (1.0 - t2 * c1) / kappa
    p = -(T / kappa) * c1 + (T**2 / 4.0) * (c1**2 + c2)
    xy = (x + y) / sigma**2
    l1 = 1.0 / kappa - (T / 2.0) * c1 - xy * (c1 - t2 * c2) + W * q
    l2 = (-1.0 / kappa**2 + (T**2 / 4.0) * c2
          + xy * (T * c2 - kappa * (T**2 / 2.0) * c2 * c1)
          + (z**2 + nu**2 - W - W**2) * q**2 + W * p)
    m1 = -(sigma**2 / kappa) * l1
    s2 = -(sigma**4 / kappa**3) * l1 + (sigma**4 / kappa**2) * l2
    return m1, s2


def log_phi(a, x, y, kappa, theta, sigma, T):
    """log of the BK Laplace transform E[e^{-a IV} | x, y] (validation)."""
    nu = 2.0 * kappa * theta / sigma**2 - 1.0
    g = np.sqrt(kappa**2 + 2.0 * sigma**2 * a)
    def piece(gam):
        s = np.sinh(gam * T / 2.0)
        coth = np.cosh(gam * T / 2.0) / s
        z = (2.0 * np.sqrt(x * y) / sigma**2) * gam / s
        logI = np.log(special.ive(nu, z)) + z
        return (np.log(gam) - np.log(s) - ((x + y) / sigma**2) * gam * coth
                + logI)
    return piece(g) - piece(kappa)


def validate_moments():
    print("== moment validation (FD of log Phi) ==")
    rng = np.random.default_rng(0)
    ok = True
    for name, m in MARKETS.items():
        kappa, theta, sigma = m["kappa"], m["theta"], m["sigma"]
        for _ in range(4):
            x = m["V0"]
            y = float(rng.uniform(0.2, 3.0)) * theta
            T = 1.0
            h = 1e-4
            lp = log_phi(+h, x, y, kappa, theta, sigma, T)
            lm = log_phi(-h, x, y, kappa, theta, sigma, T)
            m1_fd = -(lp - lm) / (2 * h)
            s2_fd = (lp + lm) / h**2
            m1, s2 = iv_cond_moments(x, y, kappa, theta, sigma, T)
            e1 = abs(m1 - m1_fd) / abs(m1_fd)
            e2 = abs(s2 - s2_fd) / abs(s2_fd)
            ok &= e1 < 1e-5 and e2 < 1e-3
            if e1 > 1e-5 or e2 > 1e-3:
                print(f"  {name}: y={y:.4f} m1 {m1:.6g} vs {m1_fd:.6g}  "
                      f"s2 {s2:.6g} vs {s2_fd:.6g}  rel ({e1:.2e},{e2:.2e})")
    print("  analytic moments match FD" if ok else "  *** MISMATCH ***")

    # unconditional-mean check: E_y[m1] == theta*T + (x-theta)(1-e^-kT)/k
    for name, m in MARKETS.items():
        kappa, theta, sigma, x = m["kappa"], m["theta"], m["sigma"], m["V0"]
        T = 1.0
        d = 4.0 * kappa * theta / sigma**2
        em = -np.expm1(-kappa * T)
        csc = sigma**2 * em / (4.0 * kappa)
        lam = x * np.exp(-kappa * T) / csc
        u = (np.arange(1 << 16) + 0.5) / (1 << 16)
        y = csc * stats.ncx2.ppf(u, d, lam)
        m1, _ = iv_cond_moments(x, y, kappa, theta, sigma, T)
        want = theta * T + (x - theta) * em / kappa
        got = float(np.mean(m1))
        print(f"  {name:8s} E[m1]={got:.6f}  analytic={want:.6f}  "
              f"rel={abs(got-want)/want:.2e}")


def iv_cond_cumulants_fd(x, y, kappa, theta, sigma, T, h=0.08):
    """First three cumulants of IV | x,y by 5-point FD of log Phi (f64).

    Experiment-only oracle for the 3-moment family; the analytic closed
    form replaces this if the 3-moment match wins."""
    l = [log_phi(a, x, y, kappa, theta, sigma, T)
         for a in (-2 * h, -h, h, 2 * h)]
    lm2, lm1, lp1, lp2 = l
    c1 = -(-lp2 + 8 * lp1 - 8 * lm1 + lm2) / (12 * h)
    c2 = (-lp2 + 16 * lp1 + 16 * lm1 - lm2) / (12 * h**2)
    c3 = -(lp2 - 2 * lp1 + 2 * lm1 - lm2) / (2 * h**3)
    return c1, c2, c3


def sample_shifted_gamma(c1, c2, c3, u):
    """3-moment matched shift + Gamma(k, scale): skew 2/sqrt(k)."""
    c3 = np.maximum(c3, 1e-30)
    k = 4.0 * c2**3 / c3**2
    scale = c3 / (2.0 * c2)
    shift = c1 - k * scale
    draw = shift + scale * special.gammaincinv(k, u)
    return np.maximum(draw, 1e-12)


def sample_ig(mu, lam, z_norm, u_branch):
    """Inverse-Gaussian(mu, lam) via the Michael-Schucany-Haas transform."""
    ysq = z_norm**2
    x = mu + mu**2 * ysq / (2 * lam) - (mu / (2 * lam)) * np.sqrt(
        4 * mu * lam * ysq + mu**2 * ysq**2)
    take_x = u_branch <= mu / (mu + x)
    return np.where(take_x, x, mu**2 / np.maximum(x, 1e-300))


def bessel_ratio_cf(nu, z, iters=24):
    """I_{nu+1}(z)/I_nu(z) by the backward Perron continued fraction,
    fixed trip count — the branchless kernel form.  r_m = z/(2(nu+m)+z r)."""
    r = np.zeros_like(z)
    for m_i in range(iters, 0, -1):
        r = z / (2.0 * (nu + m_i) + z * r)
    return r


def poisson_inv(mu, u, kmax=32):
    """Poisson(mu) count by CDF inversion from one uniform, fixed kmax trip
    (branchless kernel form: running product + masked count)."""
    p = np.exp(-mu)
    cdf = p.copy()
    n = np.zeros_like(mu)
    for k_i in range(1, kmax + 1):
        n = np.where(u > cdf, float(k_i), n)
        p = p * mu / k_i
        cdf = cdf + p
    return n


def gamma_wh(alpha, z):
    """Gamma(alpha, 1) draw by Wilson-Hilferty from one normal."""
    g = alpha * np.maximum(
        1.0 - 1.0 / (9.0 * alpha) + z / (3.0 * np.sqrt(alpha)), 0.0) ** 3
    return g


# --- saddlepoint gamma quantile (Temme inversion + fitted corrections) ------
# P(a, x) ~ Phi(eta*sqrt(a)) with eta^2/2 = lam - 1 - ln lam, lam = x/a
# (Temme 1992 asymptotic inversion).  Given the normal draw z: eta0 = z/sqrt(a),
# eta = eta0 + eps1(eta0)/a + P2(eta0/SC)/a^2 + P3(eta0/SC)/a^3, x = a*lam(eta).
# eps1 = ln(eta/(lam-1))/eta is Temme's exact first correction (WH is this
# inversion truncated after eps1 near the center); P2/P3 are least-squares
# fits of the remaining defect against scipy gammaincinv over a in [0.8, 100],
# z in [-6.6, 6.6] (offline; see the fitting study in the repo history).
# Max |P(a, draw(z)) - Phi(z)| <= 6.4e-5 in range vs 1.9e-2 for WH at a=0.8.
GQ_SC = 7.5
GQ_P2 = (-1.76222600e-02, -2.93765073e-02, 2.14155241e-01, -2.72541844e-01,
         -8.34309734e-01, 1.90338824e+00, 1.60407347e+00, -5.14361722e+00,
         -1.51201354e+00, 7.20404411e+00, 3.65575150e-01, -5.21675853e+00,
         4.56357262e-01, 1.55081017e+00, -2.78395827e-01)
GQ_P3 = (5.39443911e-03, -1.14541171e-02, -3.45087047e-02, 1.30529962e-01,
         4.88113067e-02, -4.25758711e-01, 6.65709220e-02, 5.57799053e-01,
         -1.97560263e-01, -2.55404255e-01, 1.14194771e-01)


def lam_of_eta(eta, newton=3):
    """Solve lam - 1 - ln(lam) = eta^2/2 (sign(eta) = sign(lam-1)),
    branchless: series for |eta| < 0.5, Newton from a cube/exp start else."""
    lam_s = 1.0 + eta * (1.0 + eta * (1.0 / 3.0 + eta * (1.0 / 36.0
            + eta * (-1.0 / 270.0 + eta * (1.0 / 4320.0)))))
    lam = np.where(eta > -2.4,
                   np.maximum((1.0 + eta / 3.0) ** 3, 1e-12),
                   np.exp(-1.0 - 0.5 * eta * eta))
    tgt = 0.5 * eta * eta
    for _ in range(newton):
        f = lam - 1.0 - np.log(np.maximum(lam, 1e-300)) - tgt
        den = np.where(np.abs(lam - 1.0) < 1e-12, 1e-12, lam - 1.0)
        lam = np.maximum(lam - f * lam / den, 1e-300)
    return np.where(np.abs(eta) < 0.5, lam_s, lam)


def gamma_sp(alpha, z):
    """Gamma(alpha, 1) quantile at Phi(z) by the corrected saddlepoint
    inversion — the branchless fixed-trip form a fused kernel can run."""
    eta0 = z / np.sqrt(alpha)
    lam0 = lam_of_eta(eta0)
    w = lam0 - 1.0
    e1 = np.where(np.abs(eta0) >= 0.1,
                  np.log(np.maximum(eta0 / np.where(np.abs(w) < 1e-300, 1.0, w),
                                    1e-300))
                  / np.where(np.abs(eta0) < 1e-300, 1.0, eta0),
                  -1.0 / 3.0 + eta0 / 36.0 + eta0 * eta0 / 1620.0)
    t = np.clip(eta0 / GQ_SC, -1.0, 1.0)
    q2 = np.polyval(GQ_P2[::-1], t)
    q3 = np.polyval(GQ_P3[::-1], t)
    inv_a = 1.0 / alpha
    eta = eta0 + inv_a * (e1 + inv_a * (q2 + inv_a * q3))
    return alpha * lam_of_eta(eta)


def pg_transition(x, kappa, theta, sigma, dt, uy, uz, ub, gamma_mode, ub2=None):
    """Exact CIR transition as Poisson(lam/2)-mixed Gamma(d/2+N, 2*cfac).

    gamma_mode: 'exact' = gammaincinv; 'wh' = Wilson-Hilferty with the
    shape-boost Gamma(a) = Gamma(a+1) * U^(1/a) (branchless, kernel form);
    'wh2' = double boost Gamma(a) = Gamma(a+2) * U1^(1/(a+1)) * U2^(1/a)
    (WH at a+2 where its distributional error is smaller); 'sp' = the
    corrected saddlepoint quantile :func:`gamma_sp`, same boost as 'wh'."""
    d = 4.0 * kappa * theta / sigma**2
    em = -np.expm1(-kappa * dt)
    cfac = sigma**2 * em / (4.0 * kappa)
    lam = x * np.exp(-kappa * dt) / cfac
    n = poisson_inv(lam / 2.0, uy)
    alpha = d / 2.0 + n
    if gamma_mode == "exact":
        g = special.gammaincinv(alpha, uz)
    elif gamma_mode == "wh2":
        zn = stats.norm.ppf(uz)
        g = (gamma_wh(alpha + 2.0, zn)
             * np.maximum(ub, 1e-300) ** (1.0 / (alpha + 1.0))
             * np.maximum(ub2, 1e-300) ** (1.0 / alpha))
    elif gamma_mode == "sp":
        zn = stats.norm.ppf(uz)
        g = gamma_sp(alpha + 1.0, zn) * np.maximum(ub, 1e-300) ** (1.0 / alpha)
    else:
        zn = stats.norm.ppf(uz)
        g = gamma_wh(alpha + 1.0, zn) * np.maximum(ub, 1e-300) ** (1.0 / alpha)
    return 2.0 * cfac * g


def qe_transition(x, kappa, theta, sigma, dt, u):
    """Andersen QE one-step draw of V_{t+dt} | V_t = x from one uniform."""
    e = np.exp(-kappa * dt)
    m = theta + (x - theta) * e
    s2 = (x * sigma**2 * e * (1 - e) / kappa
          + theta * sigma**2 * (1 - e) ** 2 / (2 * kappa))
    psi = s2 / m**2
    # quadratic branch
    b2 = np.maximum(2.0 / psi - 1.0, 0.0)
    b2 = b2 + np.sqrt(np.maximum((2.0 / psi) * b2, 0.0))
    a = m / (1.0 + b2)
    z = stats.norm.ppf(u)
    y_quad = a * (np.sqrt(b2) + z) ** 2
    # exponential branch
    p = (psi - 1.0) / (psi + 1.0)
    beta = (1.0 - p) / m
    y_exp = np.where(u <= p, 0.0,
                     np.log((1.0 - p) / np.maximum(1.0 - u, 1e-300)) / beta)
    return np.where(psi <= 1.5, y_quad, y_exp)


def segmented_price(market, family, nseg, transition, n, seed):
    """nseg big steps: exact/QE V-transition + moment-matched IV per segment."""
    kappa, theta, sigma, rho = (market["kappa"], market["theta"],
                                market["sigma"], market["rho"])
    T = 366.0 / 365.0  # ACT/365 over the leap year, matches the CM oracle dates
    dt = T / nseg
    d = 4.0 * kappa * theta / sigma**2
    em = -np.expm1(-kappa * dt)
    cfac = sigma**2 * em / (4.0 * kappa)

    ndim = 5 * nseg if transition.startswith("pg") else 3 * nseg
    sob = stats.qmc.Sobol(d=ndim, scramble=True, seed=seed)
    u = np.clip(sob.random(n), 1e-12, 1 - 1e-12)
    dim_per = ndim // nseg

    x0 = np.full(n, market["V0"])
    x = x0
    iv = np.zeros(n)
    if transition == "pgwh2" and family == "ig":
        # the 5-dims-per-segment layout has no free dimension for the double
        # boost: u2 would serve BOTH the IG bridge and the second WH boost,
        # silently correlating the transition with the bridge draw
        raise ValueError("family='ig' cannot combine with transition='pgwh2'")
    use_cf = transition in ("pgwh", "pgwh2", "pgsp")
    for i in range(nseg):
        uy, u1, u2 = (u[:, dim_per * i], u[:, dim_per * i + 1],
                      u[:, dim_per * i + 2])
        if transition == "exact":
            lam = x * np.exp(-kappa * dt) / cfac
            y = cfac * stats.ncx2.ppf(uy, d, lam)
        elif transition.startswith("pg"):
            uz, ub = u[:, dim_per * i + 3], u[:, dim_per * i + 4]
            mode = {"pgexact": "exact", "pgwh": "wh", "pgwh2": "wh2",
                    "pgsp": "sp"}[transition]
            y = pg_transition(x, kappa, theta, sigma, dt, uy, uz, ub, mode,
                              ub2=u2)
        else:
            y = qe_transition(x, kappa, theta, sigma, dt, uy)
        y = np.maximum(y, 1e-12)
        m1, s2 = iv_cond_moments(x, y, kappa, theta, sigma, dt, use_cf=use_cf)
        m1 = np.maximum(m1, 1e-12)
        s2 = np.maximum(s2, 1e-18)
        if family == "ig":
            iv_seg = sample_ig(m1, m1**3 / s2, stats.norm.ppf(u1), u2)
        elif family == "lognormal":
            s_ln2 = np.log1p(s2 / m1**2)
            iv_seg = np.exp(np.log(m1) - 0.5 * s_ln2
                            + np.sqrt(s_ln2) * stats.norm.ppf(u1))
        elif family == "gamma":
            iv_seg = (s2 / m1) * special.gammaincinv(m1**2 / s2, u1)
        elif family == "gamma3":
            c1, c2, c3 = iv_cond_cumulants_fd(x, y, kappa, theta, sigma, dt)
            iv_seg = sample_shifted_gamma(c1, np.maximum(c2, 1e-18), c3, u1)
        elif family == "gammasp":
            iv_seg = np.maximum(
                (s2 / m1) * gamma_sp(m1**2 / s2, stats.norm.ppf(u1)), 1e-12)
        elif family in ("gammawh", "gamma3wh"):
            # Wilson-Hilferty: Gamma(k) ~= k*(1 - 1/(9k) + Z/(3 sqrt k))^3,
            # branchless from ONE normal — what a fused kernel would sample.
            if family == "gammawh":
                k, scale, shift = m1**2 / s2, s2 / m1, 0.0
            else:
                cc1, cc2, cc3 = iv_cond_cumulants_fd(x, y, kappa, theta,
                                                     sigma, dt)
                cc2 = np.maximum(cc2, 1e-18)
                cc3 = np.maximum(cc3, 1e-30)
                k = 4.0 * cc2**3 / cc3**2
                scale = cc3 / (2.0 * cc2)
                shift = cc1 - k * scale
            zn = stats.norm.ppf(u1)
            g = k * np.maximum(1.0 - 1.0 / (9.0 * k)
                               + zn / (3.0 * np.sqrt(k)), 0.0) ** 3
            iv_seg = np.maximum(shift + scale * g, 1e-12)
        elif family == "mean":
            iv_seg = m1
        else:
            raise ValueError(family)
        iv = iv + iv_seg
        x = y

    j = (x - x0 - kappa * theta * T + kappa * iv) / sigma
    f_eff = SPOT * np.exp(R * T + rho * j - 0.5 * rho**2 * iv)
    var = np.maximum((1.0 - rho**2) * iv, 1e-18)
    sd = np.sqrt(var)
    d1 = (np.log(f_eff / STRIKE) + 0.5 * var) / sd
    vals = f_eff * stats.norm.cdf(d1) - STRIKE * stats.norm.cdf(d1 - sd)
    return float(np.exp(-R * T) * np.mean(vals))


def cm_oracle(market):
    import jax
    import hedgehog_tpu as hh
    mk = hh.HestonInputs(REF, R, SPOT, market["V0"], market["kappa"],
                         market["theta"], market["sigma"], market["rho"])
    payoff = hh.VanillaOption(STRIKE, EXPIRY, hh.European(), hh.Call(), hh.Spot())
    with jax.default_device(jax.devices("cpu")[0]):
        return float(hh.solve(hh.PricingProblem(payoff, mk),
                              hh.CarrMadan(1.0, "auto", hh.HestonDynamics())).price)


def main():
    if "--novalidate" not in sys.argv:
        validate_moments()
    # CF Bessel-ratio accuracy check (the kernel form)
    rng = np.random.default_rng(1)
    nu_t = rng.uniform(-0.55, 3.0, 64)
    z_t = 10.0 ** rng.uniform(-3, 2.2, 64)
    err = np.abs(bessel_ratio_cf(nu_t, z_t)
                 / (special.ive(nu_t + 1, z_t) / special.ive(nu_t, z_t)) - 1.0)
    print(f"CF Bessel ratio max rel err (nu in [-0.55,3], z in [1e-3,160]): "
          f"{err.max():.2e}")

    n = 1 << 18
    n_rand = 6
    configs = [
        ("gamma", 2, "pgexact"),    # isolates the 2-moment IV family bias
        ("gamma", 2, "pgwh"),       # + transition WH error
        ("gamma", 2, "pgwh2"),      # + double-boost transition WH
        ("gammawh", 2, "pgwh"),     # current kernel scheme
        ("gammawh", 2, "pgwh2"),    # kernel scheme w/ double-boost transition
        ("gamma", 2, "pgsp"),       # exact IV family + saddlepoint transition
        ("gammasp", 2, "pgsp"),     # proposed kernel scheme (saddlepoint both)
    ]
    print(f"\n== segmented bias vs Carr-Madan ({n} Sobol pts x {n_rand}) ==")
    for name, m in MARKETS.items():
        cm = cm_oracle(m)
        print(f"  {name:8s} CM={cm:9.5f}")
        for family, nseg, trans in configs:
            ps = [segmented_price(m, family, nseg, trans, n, s)
                  for s in range(n_rand)]
            mean, se = float(np.mean(ps)), float(np.std(ps) / np.sqrt(n_rand))
            print(f"    {family:9s} nseg={nseg} {trans:5s} "
                  f"bias={(mean-cm)/cm*1e4:+7.2f}bp (se {se/cm*1e4:.2f})")


if __name__ == "__main__":
    main()
