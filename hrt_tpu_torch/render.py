"""`python -m hrt_tpu_torch.render`: the render command (cli.py)."""
from .cli import main

if __name__ == "__main__":
    main()
