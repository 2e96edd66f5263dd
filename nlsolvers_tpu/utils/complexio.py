"""Real<->complex packing: the packed-API convention for complex fields.

Packed entry points (the batch and sharded trajectory engines, the sharded
steps, the datagen archives) exchange complex fields as a stacked real pair
(2, ...) = (real, imag) along axis 0, and convert inside the jitted program.
"""

import jax
import jax.numpy as jnp

__all__ = ["pack_complex", "unpack_complex", "pack_tree", "unpack_tree"]


def pack_complex(z):
    """complex (...) -> real (2, ...). Real arrays pass through unchanged."""
    if jnp.iscomplexobj(z):
        return jnp.stack([jnp.real(z), jnp.imag(z)])
    return z


def unpack_complex(rz):
    """real (2, ...) -> complex (...)."""
    return jax.lax.complex(rz[0], rz[1])


def pack_tree(tree):
    return jax.tree.map(pack_complex, tree)


def unpack_tree(tree, template):
    """Unpack leaves that were complex in `template` (a pytree of dtypes)."""
    return jax.tree.map(
        lambda rz, t: unpack_complex(rz) if jnp.iscomplexobj(t) else rz,
        tree, template)
