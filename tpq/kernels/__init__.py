"""L2 data movement: radix partition + histogram and the PAD/PACK movers
(SURVEY.md §2.1 C3), all plain `jnp`/`lax` left to XLA."""
