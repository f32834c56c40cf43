"""Traversal-kernel experiments on the card (ports of the JAX package's
experiments/ablate_packet.py, measure_packet.py, cost_model.py,
attribute_bigscene.py, measure_pair.py and ablate_pair.py): where a
traversal kernel's time goes. Each runs on the card by default and takes
--cpu (the plain version at small sizes)."""
