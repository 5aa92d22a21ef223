"""Host services: rooms/lobby storage, the batched game host, HTTP API."""
