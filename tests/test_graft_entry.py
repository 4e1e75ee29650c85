"""__graft_entry__.dryrun_multichip runs on the devices JAX already has
(the tests' 8 virtual CPU devices) and leaves the platform alone."""

import jax

import __graft_entry__ as G


def test_dryrun_multichip_uses_present_devices(monkeypatch):
    before = jax.devices()
    updates = []
    real = jax.config.update
    monkeypatch.setattr(jax.config, "update",
                        lambda name, value: (updates.append(name),
                                             real(name, value)))
    G.dryrun_multichip(2)
    assert "jax_platforms" not in updates
    assert "jax_num_cpu_devices" not in updates
    assert jax.devices() == before
