"""Entry points: the prefill and serve steps and the serving launcher."""
