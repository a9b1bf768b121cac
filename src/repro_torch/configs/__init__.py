"""Model configurations of the architectures the port serves: copies of
``repro.configs`` (framework-free dataclasses), imports rewritten."""
