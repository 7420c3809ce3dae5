"""Federated training: client data, local steps, aggregation, the round loop, tent."""
