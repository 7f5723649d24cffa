"""Random day tables for the day-scan kernel tests: seeded numpy draws
that drive the throttle, thermal and SoC paths, in the port's time-major
layout (`kernels/day_scan.py`).  numpy and torch only, so the card tests
that use it run on a machine without JAX."""
import numpy as np
import torch


def random_tables(n: int, t: int, n_lvl: int, seed: int, device) -> dict:
    """Random day tables that drive the throttle, thermal and SoC paths."""
    rng = np.random.default_rng(seed)

    def f32(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=device)

    mw = rng.uniform(300.0, 2500.0, (t, 1, n)) \
        * np.linspace(1.0, 0.4, n_lvl)[None, :, None]
    const = {k: np.full(n, v) for k, v in {
        "temp_trip": 39.5, "temp_clear": 37.0, "soc_trip": 0.3,
        "soc_clear": 0.4, "max_level": float(n_lvl - 1),
        "standby_mw": 45.0, "ste_beta_c": 2.0,
        "ste_beta_soc": 60.0, "p_standby_mw": 18.0}.items()}
    const["has_puck"] = rng.integers(0, 2, n).astype(float)
    const["shutdown_c"] = rng.choice([40.0, 46.0], n)
    for pre, cap in (("", 900.0), ("p_", 4000.0)):
        const.update({pre + "v_full": np.full(n, 4.35),
                      pre + "sag_v": np.full(n, 0.75),
                      pre + "knee_v": np.full(n, 0.3),
                      pre + "knee_sharp": np.full(n, 12.0),
                      pre + "r_ohm": np.full(n, 0.25),
                      pre + "dsoc_coeff": np.full(n, 60.0 / (3600 * cap)),
                      pre + "g_soc_skin": np.full(n, 1 / 7.0),
                      pre + "g_skin_amb": np.full(n, 1 / 11.0),
                      pre + "dt_c_soc": rng.uniform(2.0, 4.0, n),
                      pre + "dt_c_skin": np.full(n, 60.0 / 80.0)})
    valid = np.ones((t, n))
    valid[t - t // 5:, ::3] = 0.0
    return {"step_mw": f32(mw), "step_mw_p": f32(mw * 0.6),
            "step_pods": f32(rng.uniform(0, 5e3, (t, n_lvl, n))),
            "act_mult": f32(np.linspace(1.0, 0.5, n_lvl)[:, None]
                            * np.ones((1, n))),
            "ambient": f32(rng.uniform(22.0, 36.0, (t, n))),
            "active": f32(rng.uniform(0.3, 1.0, (t, n))),
            "valid": f32(valid),
            "charge": f32(np.where(rng.uniform(size=(t, n)) < 0.1, 800.0,
                                   0.0)),
            "charge_p": f32(np.zeros((t, n))),
            "const": {k: f32(v) for k, v in const.items()}}
