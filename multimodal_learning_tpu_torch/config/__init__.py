from .options import Options, parse_args, print_options
